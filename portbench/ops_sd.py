"""The FLOP model of the state-description RN, from a configuration
file's widths; peaks and ``seconds_at_peak`` are ``ops.py``'s.

Every product of one question's forward pass, with the dtype the port
runs it in: the question LSTM and f_phi in fp32, g_theta in the compute
dtype. There is no conv stem: the objects come as they are. Layer 0 of
g_theta is the per-object projections u = x W0[:c], v = x W0[c:2c] of the
n objects and the shift q W0[2c:] (the question joins at layer 0); layers
1 .. L-1 run over all n^2 pairs. Every count is of the operation as the
plain reference (``reference_sd.py``) defines it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def forward_products(w: Dict, compute_dtype: str = "bfloat16") -> List[Tuple[str, float, str]]:
    """(name, flops, dtype) of every product in one question's forward pass."""
    if w["question_injection_position"] != 0:
        raise ValueError("the FLOP model covers question injection at g layer 0 only")
    n, c = w["max_objects"], w["object_dim"]
    T, E, h = w["question_max_len"], w["lstm_word_emb"], w["lstm_hidden"]
    g = list(w["g_layers"])
    out = [("lstm", 2.0 * T * 4 * h * (E + h), "float32"),
           ("g_projections", 2.0 * (2 * n * c + h) * g[0], compute_dtype)]
    for l in range(1, len(g)):
        out.append((f"g{l}", 2.0 * n * n * g[l - 1] * g[l], compute_dtype))
    f = [g[-1], *w["f_layers"], w["n_answers"]]
    out.append(("f_phi", sum(2.0 * a * b for a, b in zip(f[:-1], f[1:])), "float32"))
    return out
