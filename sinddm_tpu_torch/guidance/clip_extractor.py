"""CLIP feature extraction for guidance: text templates, augmented views, loss
(port of ``sinddm_tpu/guidance/clip_extractor.py``).

The 16-view augmentation pipeline (resize / random crop / hflip / affine /
perspective / colour jitter / grayscale) is ONE composed homography plus a
colour transform per view, batched over images and views. The loss is
``1.2 * (1 - mean over views of cos(view embedding, text embedding))``, summed
over images and a random subset of the text templates, divided by the
subset's size.

Randomness. The JAX package draws from ``jax.random`` keys inside the
pipeline. Here every random function is split into a *draw* (from a
``torch.Generator``, on the device) and a pure *apply* that takes the draws
as tensors: :func:`draw_view_params` / :func:`view_matrices` +
:func:`apply_color`, and :func:`draw_loss_params` /
:meth:`ClipExtractor.calculate_clip_loss`. The two packages' streams differ;
a test feeds the JAX draws to the apply functions and compares the results.

Every select on a draw (flip or not, which jitter op comes next, ...) is a
tensor select batched over views: nothing here reads a device value on the
host.

Memory. The JAX package bounds memory with ``jax.checkpoint`` policies and
``lax.map`` over view chunks. Here :meth:`ClipExtractor.clip_loss_and_grad`
loops over the same chunks (``view_chunk``) and runs the backward chunk by
chunk, which is exact because the loss is linear in the per-view cosines.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from sinddm_tpu_torch.models.clip.model import CLIPModel, clip_normalize
from sinddm_tpu_torch.models.clip.tokenizer import tokenize
from sinddm_tpu_torch.ops import warp as W

TEMPLATES_HR = (
    "photo of {}.", "high quality photo of {}.", "a photo of {}.",
    "the photo of {}.", "image of {}.", "an image of {}.",
    "high quality image of {}.", "a high quality image of {}.", "the {}.",
    "a {}.", "{}.", "{}", "{}!", "{}...",
)
TEMPLATES_LR = (
    "photo of {}.", "low quality photo of {}.", "low resolution photo of {}.",
    "low-res photo of {}.", "blurry photo of {}.", "pixelated photo of {}.",
    "a photo of {}.", "the photo of {}.", "image of {}.", "an image of {}.",
    "low quality image of {}.", "a low quality image of {}.",
    "low resolution image of {}.", "a low resolution image of {}.",
    "low-res image of {}.", "a low-res image of {}.", "blurry image of {}.",
    "a blurry image of {}.", "pixelated image of {}.",
    "a pixelated image of {}.", "the {}.", "a {}.", "{}.", "{}", "{}!",
    "{}...",
)


def get_augmentations_template(flag: str = "hr") -> Tuple[str, ...]:
    if flag == "hr":
        return TEMPLATES_HR
    if flag == "lr":
        return TEMPLATES_LR
    raise NotImplementedError(flag)


def compose_text_with_templates(text: str, templates: Sequence[str]):
    return [t.format(text) for t in templates]


def resize_output_size(h: int, w: int, target: int = 224, max_size: int = 320) -> Tuple[int, int]:
    """torchvision ``T.Resize(target, max_size=...)`` output size."""
    short, long = (h, w) if h <= w else (w, h)
    new_short = target
    new_long = int(target * long / short)
    if new_long > max_size:
        new_short = int(max_size * short / long)
        new_long = max_size
    return (new_short, new_long) if h <= w else (new_long, new_short)


class ViewDraws(NamedTuple):
    """The random numbers of the views of B images x V views, one field per
    draw of the JAX pipeline, with that draw's range."""

    crop_scale: torch.Tensor  # [B, V]    U(0.6, 1): crop side as a share of the image
    crop_uy: torch.Tensor     # [B, V]    U(0, 1): crop offset, rows
    crop_ux: torch.Tensor     # [B, V]    U(0, 1): crop offset, columns
    flip_u: torch.Tensor      # [B, V]    U(0, 1): hflip when < 0.5
    affine_u: torch.Tensor    # [B, V]    U(0, 1): affine when < 0.8
    angle: torch.Tensor       # [B, V]    U(-15, 15) degrees
    tx: torch.Tensor          # [B, V]    U(-0.1, 0.1) of the frame width
    ty: torch.Tensor          # [B, V]    U(-0.1, 0.1) of the frame height
    persp_u: torch.Tensor     # [B, V]    U(0, 1): perspective when < 0.5
    persp_dx: torch.Tensor    # [B, V, 4] U(0, 1): corner displacement shares
    persp_dy: torch.Tensor    # [B, V, 4]
    jitter_u: torch.Tensor    # [B, V]    U(0, 1): colour jitter when < 0.7
    gray_u: torch.Tensor      # [B, V]    U(0, 1): grayscale when < 0.15
    jitter_f: torch.Tensor    # [B, V, 4] U(0.9, 1.1): brightness, contrast, saturation factors (4th unused)
    hue: torch.Tensor         # [B, V]    U(-0.1, 0.1)
    perm: torch.Tensor        # [B, V, 4] int64 permutation of 0..3: the order of the jitter ops

    def views(self, lo: int, hi: int) -> "ViewDraws":
        return ViewDraws(*(f[:, lo:hi] for f in self))

    def rows(self, lo: int, hi: int) -> "ViewDraws":
        """The draws of images ``lo .. hi - 1``."""
        return ViewDraws(*(f[lo:hi] for f in self))


class LossDraws(NamedTuple):
    """The random numbers of one call of the CLIP loss."""

    n_sel: torch.Tensor  # [] int64 in 1..N: how many templates count
    idx: torch.Tensor    # [N] int64 in 0..N-1: templates drawn with replacement (the first n_sel count)
    views: ViewDraws

    def rows(self, lo: int, hi: int) -> "LossDraws":
        """The draws of images ``lo .. hi - 1`` of the batch: their views'
        rows; the template draws are the whole batch's."""
        return LossDraws(self.n_sel, self.idx, self.views.rows(lo, hi))


def draw_view_params(batch: int, n_aug: int, generator: Optional[torch.Generator], device) -> ViewDraws:
    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand((batch, n_aug) + shape, generator=generator, device=device) * (hi - lo) + lo

    return ViewDraws(
        crop_scale=u(lo=0.6, hi=1.0), crop_uy=u(), crop_ux=u(), flip_u=u(), affine_u=u(),
        angle=u(lo=-15.0, hi=15.0), tx=u(lo=-0.1, hi=0.1), ty=u(lo=-0.1, hi=0.1), persp_u=u(),
        persp_dx=u(4), persp_dy=u(4), jitter_u=u(), gray_u=u(), jitter_f=u(4, lo=0.9, hi=1.1),
        hue=u(lo=-0.1, hi=0.1), perm=u(4).argsort(dim=-1),
    )


def draw_loss_params(batch: int, n_aug: int, n_templates: int,
                     generator: Optional[torch.Generator], device) -> LossDraws:
    n_sel = torch.randint(1, n_templates + 1, (), generator=generator, device=device)
    idx = torch.randint(0, n_templates, (n_templates,), generator=generator, device=device)
    return LossDraws(n_sel, idx, draw_view_params(batch, n_aug, generator, device))


def augs_matrix(d: ViewDraws, hw: Tuple[int, int]) -> torch.Tensor:
    """The shared augmentation homography [B, V, 3, 3] over the view frame:
    HFlip(0.5) @ Affine(+-15 deg, translate +-0.1, p=0.8) @ Perspective(0.4, p=0.5)."""
    h, w = hw
    one, zero = torch.ones_like(d.flip_u), torch.zeros_like(d.flip_u)
    eye = W._rows([[one, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])

    do_flip = d.flip_u < 0.5
    m_flip = W._rows([[torch.where(do_flip, -one, one), 0.0, torch.where(do_flip, one * float(w - 1), zero)],
                      [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])

    do_aff = (d.affine_u < 0.8)[..., None, None]
    m_aff = torch.where(do_aff, W.affine_matrix(d.angle, (d.tx * w, d.ty * h), (h, w)), eye)

    do_persp = (d.persp_u < 0.5)[..., None, None]
    half_h, half_w = h // 2, w // 2
    dx = d.persp_dx * (0.4 * half_w + 1)
    dy = d.persp_dy * (0.4 * half_h + 1)
    corner_list = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
    sign_list = [[1, 1], [-1, 1], [-1, -1], [1, -1]]
    # corners and signs as fills beside the draws (no host-to-device copy)
    endpoints = torch.stack([
        torch.stack([dx[..., k] * sx + float(cx), dy[..., k] * sy + float(cy)], dim=-1)
        for k, ((cx, cy), (sx, sy)) in enumerate(zip(corner_list, sign_list))
    ], dim=-2)  # [B, V, 4, 2]
    corners = torch.stack([
        torch.stack([zero + float(cx), zero + float(cy)], dim=-1) for cx, cy in corner_list
    ], dim=-2)
    m_persp = torch.where(do_persp, W.perspective_matrix(corners, endpoints), eye)
    return m_flip @ m_aff @ m_persp


def view_matrices(d: ViewDraws, idxs: Sequence[int], src_hw: Tuple[int, int],
                  frame_hw: Tuple[int, int]) -> torch.Tensor:
    """Out->in homographies [B, V, 3, 3] of the views named by ``idxs`` (the
    view numbers of ``d``'s V columns): view 0 is the whole image resized to
    the frame, the others a random crop (side U(0.6, 1) of the image) resized
    to it; then the shared augmentations."""
    h, w = src_hw
    ch, cw = frame_hw
    s = d.crop_scale
    full = W.crop_resize_matrix(torch.zeros_like(s), torch.zeros_like(s),
                                torch.full_like(s, float(h)), torch.full_like(s, float(w)), (ch, cw))
    crop_h = torch.floor(h * s)
    crop_w = torch.floor(w * s)
    y0 = torch.floor(d.crop_uy * (h - crop_h + 1))
    x0 = torch.floor(d.crop_ux * (w - crop_w + 1))
    crop = W.crop_resize_matrix(y0, x0, crop_h, crop_w, (ch, cw))
    m_crop = crop
    for col, i in enumerate(idxs):  # which column is view 0 is known on the host
        if i == 0:
            m_crop = torch.cat([crop[:, :col], full[:, col : col + 1], crop[:, col + 1 :]], dim=1)
    return m_crop @ augs_matrix(d, (ch, cw))


def apply_color(x: torch.Tensor, d: ViewDraws) -> torch.Tensor:
    """ColorJitter(0.1 x 4, p=0.7) in the drawn op order, then Grayscale(0.15),
    on views x [B, V, h, w, 3] in [0, 1]. Every op is computed for every view
    and the drawn one selected, as the JAX package's ``lax.switch`` does
    under ``vmap``."""
    e5 = lambda t: t[..., None, None, None]  # noqa: E731  [B, V] -> [B, V, 1, 1, 1]
    fb = d.jitter_f
    v = x
    for i in range(4):
        op = e5(d.perm[..., i])
        v = torch.where(
            op == 0, W.adjust_brightness(v, e5(fb[..., 0])),
            torch.where(op == 1, W.adjust_contrast(v, e5(fb[..., 1])),
                        torch.where(op == 2, W.adjust_saturation(v, e5(fb[..., 2])),
                                    W.adjust_hue(v, d.hue[..., None, None]))))
    x = torch.where(e5(d.jitter_u < 0.7), v, x)
    g = W.rgb_to_grayscale(x).expand_as(x)
    return torch.where(e5(d.gray_u < 0.15), g, x)


def augment_views(img: torch.Tensor, d: ViewDraws, idxs: Sequence[int], fill: float = 1.0,
                  mm_adjoint: bool = True, warp_precision: Optional[str] = None,
                  warp_impl: Optional[str] = None, valid_hw: Optional[Tuple[int, int]] = None,
                  frame_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Images [B, H, W, 3] in [0, 1] -> the views of ``d`` [B, V, ch, cw, 3].
    The frame is the image resized to short side 224, long side at most 320.

    The bucketed walk passes ``valid_hw``, the image's top-left valid region
    on a padded canvas, and ``frame_hw``, a fixed frame: the crops and
    resizes are then taken from the valid region, and the warp still reads
    the whole canvas, so a tap past the valid edge reads the canvas's zeros
    (not the warp's fill), as in the JAX package."""
    full_hw = (img.shape[1], img.shape[2])
    frame = resize_output_size(*full_hw) if frame_hw is None else tuple(frame_hw)
    m_total = view_matrices(d, idxs, full_hw if valid_hw is None else tuple(valid_hw), frame)
    view = W.warp_homography(img, m_total, frame, fill=fill, mm_adjoint=mm_adjoint,
                             precision=warp_precision, impl=warp_impl)
    return W.clip01(apply_color(W.clip01(view), d))


class ClipExtractor:
    """Frozen CLIP + the guidance loss. ``generator`` feeds the draws that a
    caller does not supply."""

    def __init__(self, model: CLIPModel, n_aug: int = 16, affine_fill: float = 1.0,
                 view_chunk: Optional[int] = 4, mm_adjoint: bool = True,
                 warp_precision: Optional[str] = None, warp_impl: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.n_aug = n_aug
        self.affine_fill = affine_fill
        # encode (and differentiate) at most view_chunk views an image at a
        # time; None = all at once
        self.view_chunk = view_chunk
        self.mm_adjoint = mm_adjoint
        # precision of the matrix-product warp (ops/warp.py matmul_precision);
        # None = true fp32
        self.warp_precision = warp_precision
        self.warp_impl = warp_impl
        self.generator = generator

    @property
    def device(self):
        return self.model.positional_embedding.device

    def _chunk_size(self) -> int:
        """Largest divisor of n_aug that is <= view_chunk."""
        if self.view_chunk is None or self.view_chunk >= self.n_aug:
            return self.n_aug
        c = max(1, min(self.view_chunk, self.n_aug))
        while self.n_aug % c:
            c -= 1
        return c

    def draw(self, batch: int, n_templates: int) -> LossDraws:
        return draw_loss_params(batch, self.n_aug, n_templates, self.generator, self.device)

    # -- text ----------------------------------------------------------
    @torch.no_grad()
    def get_text_embedding(self, text, template: Sequence[str], average_embeddings: bool = False) -> torch.Tensor:
        """[N_templates, D] raw (unnormalised) text embeddings."""
        if isinstance(text, str):
            text = [text]
        embs = []
        for prompt in text:
            toks = torch.from_numpy(tokenize(compose_text_with_templates(prompt, template))).long()
            embs.append(self.model.encode_text(toks.to(self.device)))
        out = torch.cat(embs, dim=0)
        return out.mean(dim=0, keepdim=True) if average_embeddings else out

    # -- images --------------------------------------------------------
    def _embed_chunk(self, x01: torch.Tensor, d: ViewDraws, lo: int, hi: int, valid_hw=None,
                     frame_hw=None) -> torch.Tensor:
        views = augment_views(x01, d.views(lo, hi), range(lo, hi), self.affine_fill,
                              mm_adjoint=self.mm_adjoint, warp_precision=self.warp_precision,
                              warp_impl=self.warp_impl, valid_hw=valid_hw, frame_hw=frame_hw)
        b, c = views.shape[:2]
        embs = self.model.encode_image(clip_normalize(views.reshape((b * c,) + views.shape[2:])))
        return embs.reshape(b, c, -1)

    def embed_image_views(self, x01: torch.Tensor, d: ViewDraws, valid_hw=None, frame_hw=None) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> [B, n_aug, D] embeddings of the views of
        ``d`` (``valid_hw`` / ``frame_hw`` as in :func:`augment_views`)."""
        c = self._chunk_size()
        return torch.cat([self._embed_chunk(x01, d, lo, lo + c, valid_hw, frame_hw)
                          for lo in range(0, self.n_aug, c)], dim=1)

    # -- loss ----------------------------------------------------------
    def _loss_terms(self, text_embeds: torch.Tensor, draws: LossDraws, batch: int):
        """The loss is ``const - sum over views of weight . cos``: returns
        (const, normalised selected text embeddings [N, D], weight [N])."""
        n_total = text_embeds.shape[0]
        sel = (torch.arange(n_total, device=text_embeds.device) < draws.n_sel).to(torch.float32)
        selected = text_embeds[draws.idx]
        txt_n = selected / selected.norm(dim=-1, keepdim=True)
        const = 1.2 * batch * sel.sum() / draws.n_sel
        return const, txt_n, 1.2 * sel / (draws.n_sel * self.n_aug)

    @staticmethod
    def _cos_sum(embs: torch.Tensor, txt_n: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        img_n = embs / embs.norm(dim=-1, keepdim=True)
        return (torch.einsum("bvd,td->bvt", img_n, txt_n) * weight).sum()

    def calculate_clip_loss(self, x01: torch.Tensor, text_embeds: torch.Tensor,
                            draws: Optional[LossDraws] = None, valid_hw=None, frame_hw=None) -> torch.Tensor:
        """Stochastic-template CLIP loss of images x01 [B, H, W, 3] in [0, 1]:
        ``sum over images and the first n_sel drawn templates of
        1.2 (1 - mean over views of cos) / n_sel``. Differentiable in x01.
        ``valid_hw`` / ``frame_hw``: the views of a padded canvas
        (:func:`augment_views`)."""
        if draws is None:
            draws = self.draw(x01.shape[0], text_embeds.shape[0])
        const, txt_n, weight = self._loss_terms(text_embeds, draws, x01.shape[0])
        return const - self._cos_sum(self.embed_image_views(x01, draws.views, valid_hw, frame_hw), txt_n, weight)

    def clip_loss_and_grad(self, x01: torch.Tensor, text_embeds: torch.Tensor,
                           draws: Optional[LossDraws] = None, valid_hw=None,
                           frame_hw=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`calculate_clip_loss` and its gradient in x01, the backward
        run view chunk by view chunk so that one chunk's activations live at
        a time. Works under ``torch.no_grad()``."""
        if draws is None:
            draws = self.draw(x01.shape[0], text_embeds.shape[0])
        const, txt_n, weight = self._loss_terms(text_embeds, draws, x01.shape[0])
        leaf = x01.detach().requires_grad_(True)
        loss = const
        grad = torch.zeros_like(leaf)
        c = self._chunk_size()
        with torch.enable_grad():
            for lo in range(0, self.n_aug, c):
                term = self._cos_sum(self._embed_chunk(leaf, draws.views, lo, lo + c, valid_hw, frame_hw),
                                     txt_n, weight)
                grad -= torch.autograd.grad(term, leaf)[0]
                loss = loss - term.detach()
        return loss, grad
