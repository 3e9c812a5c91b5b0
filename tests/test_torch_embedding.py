"""The question embedding's backward (``rnet_torch/kernels/embedding.py``)
on the CPU: the plain version, which adds in the kernel's order, against
``index_put_``'s gradient of ``weight[tokens] * mask`` and against a literal
walk of the kernel's warps; the autograd Function; the routes
``QuestionEmbedModel`` takes off the card; the launch counter; and the
kernel's names against the benchmark's readers (the kernel itself runs in
``chip_smoke.py`` phase 9b).
"""

import importlib.util
import math
import os
import re

import numpy as np
import pytest
import torch

from portbench.readers import HANDWRITTEN
from rnet_torch.kernels import embedding as em
from rnet_torch.kernels import pairwise
from rnet_torch.kernels.build import source_path
from rnet_torch.models.text import QuestionEmbedModel
from rnet_torch.train import graphs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tokens(case, rs):
    """(B, T) int64 ids, V and E for a named case."""
    if case == "odd_shape":  # V and E no multiples of 32
        B, T, V, E = 3, 7, 11, 20
    else:
        B, T, V, E = 24, 48, 90, 32
    tok = rs.randint(1, V, size=(B, T))
    if case in ("pads", "odd_shape"):
        lengths = rs.randint(1, T + 1, size=B)
        lengths[0] = 0  # a row of pads alone
        tok[np.arange(T)[None, :] >= lengths[:, None]] = 0
    elif case == "all_pads":
        tok[:] = 0
    elif case == "one_token":
        tok[:] = 7
    return torch.from_numpy(tok).long(), V, E


def _parent_grad(tok, V, g):
    """``index_put_``'s gradient of the expression the port ran before."""
    w = torch.randn((V, g.shape[-1]), requires_grad=True)
    (grad,) = torch.autograd.grad(w[tok] * (tok != 0)[..., None], w, g)
    return grad


def _exact_and_bound(tok, V, g):
    """The float64 sum and the bound of any fp32 order's error (n terms a
    row: n * 2**-24 * the sum of |terms|)."""
    E = g.shape[-1]
    keep = (tok != 0)[..., None].double()
    rows = tok.reshape(-1)
    exact = torch.zeros((V, E), dtype=torch.float64).index_add_(0, rows, (g.double() * keep).reshape(-1, E))
    mag = torch.zeros((V, E), dtype=torch.float64).index_add_(0, rows, (g.double().abs() * keep).reshape(-1, E))
    n = torch.zeros((V, 1), dtype=torch.float64).index_add_(0, rows, keep.reshape(-1, 1))
    return exact, n * 2.0**-24 * mag


def _walk(dx, tok, V, plan):
    """The kernel's adds, one warp and one position at a time, in numpy fp32."""
    G, W, chunk = plan
    N, E = tok.numel(), dx.shape[-1]
    d, t = dx.reshape(N, E).numpy(), tok.reshape(N).numpy()
    partials = []
    for g in range(G):
        tables = []
        for w in range(W):
            tab = np.zeros((V, E), np.float32)
            for p in range((g * W + w) * chunk, min(N, (g * W + w + 1) * chunk)):
                if 0 < t[p] < V:
                    tab[t[p]] = tab[t[p]] + d[p]
            tables.append(tab)
        acc = tables[0]
        for tab in tables[1:]:
            acc = acc + tab
        partials.append(acc)
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    return torch.from_numpy(out)


PLANS = [None, (1, 1, None), (2, 3, None), (5, 8, None)]


def _plan(p, N, V, E):
    if p is None:
        return em.plan(N, V, E)
    G, W, _ = p
    return G, W, math.ceil(N / (G * W))


@pytest.mark.parametrize("plan_i", range(len(PLANS)))
@pytest.mark.parametrize("case", ["pads", "no_pads", "all_pads", "one_token", "odd_shape"])
def test_plain_matches_index_put_grad(case, plan_i):
    """The plain version, for the default plan and given (G, W), agrees with
    ``index_put_``'s gradient within fp32 rounding: both lie within the
    bound of any summation order of the float64 sum; pad rows give zero."""
    rs = np.random.RandomState(3 + plan_i)
    tok, V, E = _tokens(case, rs)
    g = torch.from_numpy(rs.randn(*tok.shape, E).astype(np.float32))
    plan = _plan(PLANS[plan_i], tok.numel(), V, E)
    got = em.embedding_bwd_reference(g, tok, V, plan)
    want = _parent_grad(tok, V, g)
    exact, bound = _exact_and_bound(tok, V, g)
    assert got.dtype == torch.float32 and got.shape == (V, E)
    assert ((got.double() - exact).abs() <= bound).all()
    assert ((want.double() - exact).abs() <= bound).all()
    assert torch.equal(got[0], torch.zeros(E))
    if case == "all_pads":
        assert not got.any()
    if case == "one_token":  # one row takes every position
        assert got[torch.arange(V) != 7].abs().sum() == 0


@pytest.mark.parametrize("plan_i", range(len(PLANS)))
@pytest.mark.parametrize("case", ["pads", "one_token", "odd_shape"])
def test_plain_adds_in_the_kernels_order(case, plan_i):
    """The vectorised plain version equals, bit for bit, a walk of the
    kernel's warps one position at a time (skipping pads), their tables
    added in warp order and the CTAs' partials in CTA order."""
    rs = np.random.RandomState(11 + plan_i)
    tok, V, E = _tokens(case, rs)
    g = torch.from_numpy((rs.randn(*tok.shape, E) * 10.0 ** rs.randint(-3, 4, size=(*tok.shape, 1)))
                         .astype(np.float32))
    plan = _plan(PLANS[plan_i], tok.numel(), V, E)
    assert torch.equal(em.embedding_bwd_reference(g, tok, V, plan), _walk(g, tok, V, plan))


@pytest.mark.parametrize("shape", [(640, 48, 90, 32), (512, 48, 90, 32), (3, 7, 11, 20), (1, 1, 90, 32),
                                   (8, 48, 1800, 32), (4, 48, 2000, 33)])
def test_plan_covers_every_position_once(shape):
    """Warps own consecutive, disjoint runs that cover the N positions, and
    every CTA some of them; the W tables of a CTA fit its shared memory; at
    most CTAS CTAs; a table larger than one warp may hold has no plan."""
    B, T, V, E = shape
    N = B * T
    p = em.plan(N, V, E)
    if V * E * 4 > pairwise.SMEM_LIMIT:
        assert p is None
        return
    G, W, chunk = p
    assert 1 <= G <= em.CTAS and 1 <= W <= em.WARPS and W * V * E * 4 <= pairwise.SMEM_LIMIT
    assert (G - 1) * W * chunk < N <= G * W * chunk  # every CTA has positions
    assert em.plan(N, V, E) == p  # the shape alone decides


def test_function_forward_is_the_plain_expression_and_backward_the_plain_sum():
    """The autograd Function's forward gives ``weight[tokens] * mask`` bit
    for bit; its backward (on the CPU the plain version) gives
    ``embedding_bwd_reference`` of the upstream gradient and nothing for
    the tokens or the mask."""
    rs = np.random.RandomState(5)
    tok, V, E = _tokens("pads", rs)
    mask = tok != 0
    w = torch.from_numpy(rs.randn(V, E).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rs.randn(*tok.shape, E).astype(np.float32))
    x = em._MaskedGather.apply(w, tok, mask)
    assert torch.equal(x, w[tok] * mask[..., None])
    assert type(x.grad_fn).__name__ == "_MaskedGatherBackward"
    (got,) = torch.autograd.grad(x, w, g)
    assert torch.equal(got, em.embedding_bwd_reference(g, tok, V))
    exact, bound = _exact_and_bound(tok, V, g)
    assert ((got.double() - exact).abs() <= bound).all()


def _graph_names(out):
    seen, todo, names = set(), [out.grad_fn], []
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.append(type(n).__name__)
        todo.extend(f for f, _ in n.next_functions)
    return names


def test_question_model_off_the_card_takes_the_plain_expression():
    """On the CPU, with gradients on or off, ``QuestionEmbedModel`` runs
    ``weight[tokens] * mask`` itself (its backward ``index_put_``'s), and
    ``takes_kernel`` says no; so no launch is counted."""
    rs = np.random.RandomState(6)
    tok, V, _ = _tokens("pads", rs)
    m = QuestionEmbedModel(V, 8, 16, generator=torch.Generator().manual_seed(1))
    em.reset_launches()
    assert not em.takes_kernel(m.embedding)
    names = _graph_names(m(tok))
    assert "IndexBackward0" in names and "_MaskedGatherBackward" not in names
    x = em.masked_embedding(m.embedding, tok, tok != 0)
    assert type(x.grad_fn).__name__ == "MulBackward0"
    with torch.no_grad():
        assert m(tok).grad_fn is None
        assert not em.takes_kernel(m.embedding)
    with torch.inference_mode():
        assert m(tok).grad_fn is None
    assert em.launches == {em.KERNEL: 0}


def test_counter_is_carried_by_replays_and_kept_from_the_pairwise_counts():
    """The launch counter is one of ``graphs.COUNTERS`` (replays add its
    capture increments) and not a key of ``pairwise.launches``, whose every
    key but ``g_xla`` the SD benchmark entry requires to stay 0."""
    assert any(c is em.launches for c in graphs.COUNTERS)
    assert set(em.launches) == {"embedding_bwd"}
    assert "embedding_bwd" not in pairwise.launches


def _g_reader():
    path = os.path.join(REPO, "portbench", "metrics", "device_ms.g.train.sd.py")
    spec = importlib.util.spec_from_file_location("device_ms_g_train_sd_for_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_names_stay_out_of_the_benchmarks_readers():
    """The kernels of ``csrc/embedding_bwd.cu`` match no name of
    ``portbench.readers.HANDWRITTEN`` (so they count under
    ``device_ms.other.train``) and none of ``device_ms.g.train.sd``'s
    patterns (which read g_theta alone), as a trace names them."""
    with open(source_path(em.KERNEL)) as f:
        names = re.findall(r"__global__\s+void\s+(\w+)", f.read())
    assert sorted(names) == ["embedding_bwd_kernel", "embedding_bwd_sum_kernel"]
    hand = re.compile(r"\b(?:" + "|".join(re.escape(n) for n in HANDWRITTEN) + r")\b")
    is_g = _g_reader().is_g
    for name in names:
        traced = f"void (anonymous namespace)::{name}(float const*, long long const*, float*, long long, int, int, int)"
        assert not hand.search(traced), name
        assert not is_g(traced), name
