"""The port's CUDA kernels, one wrapper module each (a plain PyTorch version
beside every kernel, run for CPU tensors)."""


def _counters() -> dict:
    """{kernel name: (wrapper, its counter attribute)}."""
    from dfmdock_tpu_torch.ops.edge_table import build_edge_table, edge_bins
    from dfmdock_tpu_torch.ops.energy_head import fused_energy
    from dfmdock_tpu_torch.ops.fused_egcl import fused_edge_layer
    from dfmdock_tpu_torch.ops.select_topk import select_topk

    return {"edge_table": (build_edge_table, "launches"),
            "fused_egcl": (fused_edge_layer, "launches"),
            "fused_egcl_coord": (fused_edge_layer, "coord_launches"),
            "fused_egcl_bf16": (fused_edge_layer, "bf16_launches"),
            "fused_egcl_coord_bf16": (fused_edge_layer, "bf16_coord_launches"),
            "fused_energy": (fused_energy, "launches"),
            "select_topk": (select_topk, "launches"),
            "edge_bins": (edge_bins, "launches")}


def launch_counts() -> dict:
    """Each kernel's launch count: the wrappers add one where they launch
    their kernel (under CUDA graph capture: where the graph records it; a
    replay calls no wrapper)."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}
