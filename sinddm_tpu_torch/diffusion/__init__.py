"""The reverse diffusion process."""
