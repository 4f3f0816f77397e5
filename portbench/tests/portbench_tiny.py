"""A cell's files cut to a size the CPU runs in seconds: the denoiser at
dim 8, T = 10, a two-scale pyramid (48x64, 72x96), batch 2, chunks of 4
steps. The limits stay the cell's."""

from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def tiny_files(cell: str, root: Path = ROOT):
    f = harness.cell_files(root, cell)
    f.config = dict(f.config, dim=8, blocks=[[3, 4], [4, 8], [8, 8], [8, 4]], timesteps=10, image_wh=[96, 72],
                    sizes_hw=[[48, 64], [72, 96]], rescale_losses=[0.5])
    f.traffic = dict(f.traffic, batch=2)
    if "steps_per_chunk" in f.traffic:
        f.traffic["steps_per_chunk"] = 4
    return f


def run_tiny(cell: str, seed: int = 2**31 + 77, trace: bool = False, root: Path = ROOT, files=None):
    files = files or tiny_files(cell, root)
    return harness.run_cell(root, cell, seed=seed, seconds=0.5, trace=trace, device="cpu", files=files,
                            log=lambda msg: None)
