"""The yardstick's arithmetic: peaks, operation and byte counts, FLOP model.

Frozen here so that a change to the port cannot move it. Sources:

* peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity (the
  table ``chip_smoke.py`` keeps as ``PEAK_*``);
* ``pairwise_fwd_work`` and ``pairwise_fwd_int8_work``: ``chip_smoke.py``'s
  ``fwd_bound`` and ``int8_bound``: the L-1 products over the n^2 pairs
  (layer 0 is the per-object projections, outside the kernel), every input
  byte read once and every output byte written once;
* ``pairwise_bwd_work``: the gradients' products alone, d = dpre W^T and
  dW = a^T dpre, twice the forward's. ``chip_smoke.py``'s ``bwd_bound``
  also counts the backward's recompute of the forward; that work is one
  implementation's choice, so it is not counted here. Bytes as
  ``bwd_bound``'s: the bf16 inputs and fp32 upstream gradient read once,
  the fp32 gradients written once;
* ``forward_products``: every product of one question's forward pass, with
  the dtype it runs in, from a configuration file's widths.

Every count is of the operation as the plain reference defines it, so it
stays the same whatever implements it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_OPS = {  # operations/s of one H100 SXM at its 700 W limit
    "bfloat16": 989e12,
    "int8": 1979e12,
    "tf32": 495e12,
    "float32": 67e12,
}
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def roofline_s(ops: float, nbytes: float, peak_ops: float) -> Tuple[float, str]:
    """(least seconds, what bounds them): the larger of ops / peak and
    bytes / HBM bandwidth."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pairwise_fwd_work(B: int, ni: int, nj: int, H: int, L: int, esize: int = 2) -> Tuple[float, float]:
    """(flops, bytes) of the pooled g chain's layers 1 .. L-1 over B * ni * nj
    pairs: u, v, s, qa, W and b read once in ``esize``-byte elements, the
    fp32 (B, H) output written once."""
    flops = 2.0 * B * ni * nj * (L - 1) * H * H
    nbytes = esize * (B * ni * H + B * nj * H + 2 * B * H + (L - 1) * H * H + (L - 1) * H) + 4.0 * B * H
    return flops, float(nbytes)


def pairwise_bwd_work(B: int, ni: int, nj: int, H: int, L: int) -> Tuple[float, float]:
    """(flops, bytes) of the chain's gradients, without the recompute."""
    flops = 2.0 * pairwise_fwd_work(B, ni, nj, H, L)[0]
    n_in = B * ni * H + B * nj * H + 2 * B * H + (L - 1) * H * H + (L - 1) * H
    return flops, 2.0 * n_in + 4.0 * B * H + 4.0 * n_in


def pairwise_fwd_int8_work(B: int, ni: int, nj: int, H: int, L: int) -> Tuple[float, float]:
    """(ops, bytes) of the int8 chain on its folded inputs: u, v, s bf16;
    qa, m, b fp32; W int8; the fp32 output written once."""
    ops = 2.0 * B * ni * nj * (L - 1) * H * H
    nbytes = 2.0 * (B * ni * H + B * nj * H + B * H) + 4.0 * (B * H + (L - 1) * (H + 1) + B * H) + (L - 1) * H * H
    return ops, nbytes


def grid_side(w: Dict) -> int:
    g = w["image_size"]
    k, s = w["conv_kernel"], w["conv_stride"]
    for _ in w["conv_channels"]:
        g = (g + 2 * (k // 2) - k) // s + 1
    return g


def forward_products(w: Dict, compute_dtype: str = "bfloat16", g_dtype: str = "") -> List[Tuple[str, float, str]]:
    """(name, flops, dtype) of every product in one question's forward pass,
    from a configuration's ``widths``: the conv stem and the projections
    in the compute dtype, the question LSTM and f_phi in fp32 (the port
    runs them so), g_theta's layers 1 .. L-1 in ``g_dtype`` (default the
    compute dtype; "int8" for the int8 chain). Layer 0 of g_theta is the
    per-object projections u = x W0[:c], v = x W0[c:2c] and the shift
    q W0[2c:] (the question joins at layer 0 in both configurations here)."""
    if w["question_injection_position"] != 0:
        raise ValueError("the FLOP model covers question injection at g layer 0 only")
    out: List[Tuple[str, float, str]] = []
    side, cin = w["image_size"], 3
    k, s = w["conv_kernel"], w["conv_stride"]
    for i, ch in enumerate(w["conv_channels"]):
        side = (side + 2 * (k // 2) - k) // s + 1
        out.append((f"conv{i}", 2.0 * side * side * ch * k * k * cin, compute_dtype))
        cin = ch
    n = side * side
    c = cin + 2  # conv features and the (x, y) coordinate tag
    T, E, h = w["question_max_len"], w["lstm_word_emb"], w["lstm_hidden"]
    out.append(("lstm", 2.0 * T * 4 * h * (E + h), "float32"))
    g = list(w["g_layers"])
    out.append(("g_projections", 2.0 * (2 * n * c + h) * g[0], compute_dtype))
    for l in range(1, len(g)):
        out.append((f"g{l}", 2.0 * n * n * g[l - 1] * g[l], g_dtype or compute_dtype))
    f = [g[-1], *w["f_layers"], w["n_answers"]]
    out.append(("f_phi", sum(2.0 * a * b for a, b in zip(f[:-1], f[1:])), "float32"))
    return out


def seconds_at_peak(products: List[Tuple[str, float, str]], factor: float = 1.0) -> float:
    """Least seconds of ``products`` with each at its dtype's peak, times
    ``factor`` (3 for a training step: the forward and a backward of twice
    its products; no recompute counted)."""
    return factor * sum(flops / PEAK_OPS[dt] for _, flops, dt in products)
