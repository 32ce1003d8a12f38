"""Serving: the pull-only forward (sparse batches and crec2 tile blocks)."""

from wormhole_tpu_torch.serve.forward import ForwardStep, tile_margins

__all__ = ["ForwardStep", "tile_margins"]
