"""What the per-layer readers under ``metrics/`` share: the context they
read and the reductions several of them make. A reader returns None where
its cell's trace has nothing for it; the harness then leaves it out."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, Optional, Sequence, Tuple

from . import ops

# Every kernel of the port's csrc/ by its __global__ name: the hand-written
# device work (all else in a step is PyTorch's: cuBLAS, cuDNN, elementwise).
HANDWRITTEN = (
    "augment_kernel",
    "pairwise_fwd_kernel", "pool_partials_kernel", "pair_mask_kernel",
    "pairwise_bwd_kernel", "reduce_partials_kernel", "reduce_dw_kernel", "dw_gemm_kernel",
    "pairwise_fwd_int8_kernel", "pairwise_fwd_int8_pair",
    "pairwise_fwd_f32_kernel", "pairwise_bwd_f32_kernel", "pairwise_fwd_f32_ring", "pairwise_bwd_f32_ring",
    "pool_kernel", "sum_partials_kernel", "reduce_dw_ring",
)


@dataclasses.dataclass
class Context:
    """A traced run's slice (``trace.Slice``, or None), the entry's counts
    over it, and the cell."""

    cell: Any
    slice: Any
    counts: Dict[str, Any]

    @property
    def widths(self) -> Dict[str, Any]:
        return self.cell.config["widths"]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic


def idle_percent(ctx: Context) -> Optional[float]:
    if ctx.slice is None or ctx.slice.busy_s() <= 0:
        return None
    return 100.0 * ctx.slice.idle_share()


def chain_shape(ctx: Context) -> Tuple[int, int, int, int]:
    """(B, n objects, H, L) of the g chain in the cell."""
    w = ctx.widths
    n = ops.grid_side(w) ** 2
    return ctx.traffic["batch_size"], n, w["g_layers"][0], len(w["g_layers"])


def roofline_percent(ctx: Context, main: Sequence[str], helpers: Sequence[str], work, peak: str) -> Optional[float]:
    """A kernel's share of its roofline: the least time of one call over the
    device time of one call (its main kernel's launches and its helpers')."""
    if ctx.slice is None:
        return None
    calls = ctx.slice.kernel_count(main)
    if calls == 0:
        return None
    t = ctx.slice.kernel_s([*main, *helpers]) / calls
    B, n, H, L = chain_shape(ctx)
    bound, _ = ops.roofline_s(*work(B, n, n, H, L), ops.PEAK_OPS[peak])
    return 100.0 * bound / t


def mfu_percent(ctx: Context, questions: float, factor: float) -> Optional[float]:
    """Questions/s over the slice times the least seconds of a question's
    products at their dtypes' peaks (``factor`` 3 for training)."""
    if ctx.slice is None or not questions:
        return None
    t = ctx.traffic
    g_dtype = "int8" if t["rl_impl"] == "pallas_int8" else ""
    least = ops.seconds_at_peak(ops.forward_products(ctx.widths, t["compute_dtype"], g_dtype), factor)
    return 100.0 * questions / ctx.slice.window_s * least


def median(values: Sequence[float]) -> Optional[float]:
    return statistics.median(values) if values else None
