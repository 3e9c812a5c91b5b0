"""rnet_torch.kernels.pairwise vs rnet.kernels.pairwise on the CPU.

On CPU tensors the port's ``pairwise_core`` takes its plain version; it is
held to rnet's jnp reference and to the Pallas kernel in interpret mode (as
tests/test_kernel.py runs it), at the tolerances of test_kernel.py. The CUDA
kernel itself runs only on the card (chip_smoke.py); here its wrapper's
refusals are checked: wrong dtype, shape or device, and a missing toolkit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnet.kernels import pairwise as jpw
from rnet.models.relational import g_input_dims
from rnet_torch.kernels import build
from rnet_torch.kernels import pairwise as tpw

torch.set_num_threads(1)


def _inputs(B, n, H, L, seed=0):
    rs = np.random.RandomState(seed)
    return [
        a.astype(np.float32)
        for a in (
            rs.randn(B, n, H) * 0.3,
            rs.randn(B, n, H) * 0.3,
            rs.randn(B, H) * 0.1,
            rs.randn(B, H) * 0.1,
            rs.randn(L - 1, H, H) / np.sqrt(H),
            rs.randn(L - 1, H) * 0.05,
        )
    ]


def _torch_core(args, inject):
    out = tpw.pairwise_core(*[torch.from_numpy(a) for a in args], inject=inject)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("L", [3, 4])
@pytest.mark.parametrize("inject", [0, 2])
@pytest.mark.parametrize("n", [16, 64])
def test_pairwise_core_matches_jax_reference(n, inject, L):
    args = _inputs(2, n, 128, L, seed=n + inject + L)
    want = jpw.pairwise_core_reference(*[jnp.asarray(a) for a in args], inject)
    np.testing.assert_allclose(_torch_core(args, inject), np.asarray(want), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("L", [3, 4])
@pytest.mark.parametrize("inject", [0, 2])
@pytest.mark.parametrize("n", [16, 64])
def test_pairwise_core_matches_pallas_interpret(n, inject, L):
    args = _inputs(2, n, 128, L, seed=n + inject + L)
    want = jpw.pairwise_core(*[jnp.asarray(a) for a in args], inject=inject, interpret=True)
    np.testing.assert_allclose(_torch_core(args, inject), np.asarray(want), rtol=2e-4, atol=2e-3)


def test_pairwise_core_rectangular():
    """u may hold a subset of the i-objects (ni != nj), as in rnet."""
    args = _inputs(2, 16, 128, 3, seed=5)
    args[0] = args[0][:, :6]
    want = jpw.pairwise_core_reference(*[jnp.asarray(a) for a in args], 1)
    np.testing.assert_allclose(_torch_core(args, 1), np.asarray(want), rtol=2e-4, atol=2e-3)


def _g_weights(c, h, H, L, inject, seed):
    rs = np.random.RandomState(seed)
    dims = g_input_dims(c, h, (H,) * L, inject)
    gw = [(rs.randn(dims[l], H) / np.sqrt(dims[l])).astype(np.float32) for l in range(L)]
    gb = [(rs.randn(H) * 0.05).astype(np.float32) for _ in range(L)]
    x = rs.randn(2, 16, c).astype(np.float32)
    q = rs.randn(2, h).astype(np.float32)
    return x, q, gw, gb


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("inject", [0, 1, 2])
def test_fused_pairwise_g_matches_jax(inject):
    x, q, gw, gb = _g_weights(10, 12, 128, 3, inject, seed=inject)
    want = jpw.fused_pairwise_g(
        jnp.asarray(x), jnp.asarray(q), [jnp.asarray(w) for w in gw], [jnp.asarray(b) for b in gb],
        inject=inject, dtype=jnp.float32,
    )
    got = tpw.fused_pairwise_g(
        torch.from_numpy(x), torch.from_numpy(q), _t(gw), _t(gb), inject=inject, dtype=torch.float32
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("inject", [0, 2])
def test_project_pair_inputs_match_jax(inject):
    """u, v, s, qa, ws, bs — including the row split of W_p at inject > 0."""
    x, q, gw, gb = _g_weights(10, 12, 128, 4, inject, seed=7 + inject)
    want = jpw._project_pair_inputs(
        jnp.asarray(x), jnp.asarray(q), [jnp.asarray(w) for w in gw], [jnp.asarray(b) for b in gb],
        inject, jnp.float32,
    )
    got = tpw._project_pair_inputs(
        torch.from_numpy(x), torch.from_numpy(q), _t(gw), _t(gb), inject, torch.float32
    )
    for name, g, w in zip(["u", "v", "s", "qa", "ws", "bs"], got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def _bf16(args):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in args]


def test_kernel_path_refuses_cpu_tensors():
    """A CUDA-kernel request on CPU tensors raises; it never computes."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpw.pairwise_fwd_cuda(*_bf16(_inputs(1, 8, 128, 3)), inject=0)


@pytest.mark.parametrize(
    "case, match",
    [
        ("float32", "bfloat16"),
        ("width", "H % 128"),
        ("one_layer", "L >= 2"),
        ("strided", "contiguous"),
        ("shape", "must be"),
    ],
)
def test_kernel_path_refuses_unsupported_inputs(case, match):
    if case == "float32":
        args = [torch.from_numpy(a) for a in _inputs(1, 8, 128, 3)]
    elif case == "width":
        args = _bf16(_inputs(1, 8, 96, 3))
    elif case == "one_layer":
        args = _bf16(_inputs(1, 8, 128, 1))
    elif case == "strided":
        args = _bf16(_inputs(1, 8, 128, 3))
        args[0] = torch.cat([args[0], args[0]], dim=1)[:, ::2]
    else:
        args = _bf16(_inputs(1, 8, 128, 3))
        args[2] = args[2][:, :64].contiguous()
    with pytest.raises(ValueError, match=match):
        tpw.pairwise_fwd_cuda(*args, inject=0)


def test_pair_dropout_not_ported_raises():
    """Pair dropout runs (below); what still raises is a request it cannot
    serve: no seed, a keep outside (0, 1], a kernel launch on CPU tensors."""
    args = _t(_inputs(1, 8, 128, 3))
    with pytest.raises(ValueError, match="seed"):
        tpw.pairwise_core(*args, inject=0, pair_keep=0.5)
    with pytest.raises(ValueError, match="pair_keep"):
        tpw.pairwise_core(*args, inject=0, pair_keep=0.0, seed=_seed(1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpw.pairwise_fwd_cuda(*_bf16(_inputs(1, 8, 128, 3)), inject=0, pair_keep=0.5, seed=_seed(1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpw.pair_mask_cuda(_seed(1), 1, 8, 8, 0.5)


# ---------------------------------------------------------------------------
# Backward: the plain version vs jax.grad of the Pallas kernel (interpret)
# ---------------------------------------------------------------------------


def _seed(k):
    return torch.tensor([k], dtype=torch.int64)


def _upstream(B, H, seed):
    return (np.random.RandomState(seed).randn(B, H)).astype(np.float32)


def _jax_vjp(args, g, inject, dtype):
    core = lambda *a: jpw.pairwise_core(*a, inject=inject, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(core, *[jnp.asarray(a, dtype) for a in args])
    return [np.asarray(d, np.float32) for d in vjp(jnp.asarray(g))]


GRAD_NAMES = ["du", "dv", "ds", "dqa", "dws", "dbs"]


@pytest.mark.parametrize("inject", [0, 2])
def test_bwd_reference_matches_jax_grad_fp32(inject):
    """fp32 inputs: the plain backward vs the VJP of rnet's Pallas kernel in
    interpret mode, at tests/test_kernel.py's VJP tolerance (rtol 5e-4,
    atol 5e-3: summation order over the 256 pair rows only)."""
    args = _inputs(2, 16, 128, 3, seed=20 + inject)
    g = _upstream(2, 128, 30 + inject)
    want = _jax_vjp(args, g, inject, jnp.float32)
    got = tpw.pairwise_core_bwd_reference(*_t(args), torch.from_numpy(g), inject)
    for name, w, d in zip(GRAD_NAMES, want, got):
        assert d.dtype == torch.float32 and tuple(d.shape) == w.shape, name
        np.testing.assert_allclose(d.numpy(), w, rtol=5e-4, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("inject", [0, 2])
def test_bwd_reference_matches_jax_grad_bf16(inject):
    """bf16 inputs: the same rounding points as _bwd_kernel. The JAX VJP
    returns bf16 gradients, so the port's fp32 ones are rounded to bf16 too;
    what is left is a one-ulp flip (2^-8 relative) of the few activations
    or dpre values whose fp32 sums land on a bf16 rounding boundary in a
    different order. Bound: 2e-2 of the gradient's largest value."""
    args = _inputs(2, 16, 128, 3, seed=40 + inject)
    g = _upstream(2, 128, 50 + inject)
    want = _jax_vjp(args, g, inject, jnp.bfloat16)
    got = tpw.pairwise_core_bwd_reference(*_bf16(args), torch.from_numpy(g), inject)
    for name, w, d in zip(GRAD_NAMES, want, got):
        d = d.to(torch.bfloat16).float().numpy()
        scale = np.abs(w).max()
        if name == "dqa" and inject == 0:
            assert scale == 0 and not d.any()
            continue
        assert np.abs(d - w).max() <= 2e-2 * scale, (name, np.abs(d - w).max(), scale)


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep", [1.0, 0.75])
@pytest.mark.parametrize("inject", [0, 1])
def test_autograd_function_matches_autograd_through_plain_forward(inject, keep):
    """fp32, where the plain forward's rounding casts are the identity: the
    Function's gradient (pairwise_core_bwd_reference) equals torch autograd
    through pairwise_core_reference, pair dropout included — so the forward
    and the backward drew the same mask. Tolerance: summation order only
    (rtol 1e-5, atol 1e-4 of values up to ~50)."""
    args = _inputs(2, 12, 128, 3, seed=60 + inject)
    g = torch.from_numpy(_upstream(2, 128, 61))
    seed = _seed(12345) if keep < 1 else None
    xs = [t.requires_grad_() for t in _t(args)]
    (tpw.pairwise_core(*xs, inject=inject, pair_keep=keep, seed=seed) * g).sum().backward()
    ys = [t.requires_grad_() for t in _t(args)]
    (tpw.pairwise_core_reference(*ys, inject, keep, seed) * g).sum().backward()
    for name, x, y in zip(GRAD_NAMES, xs, ys):
        want = torch.zeros_like(y) if y.grad is None else y.grad  # qa is unused at inject 0
        torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-4, msg=name)


def test_autograd_function_returns_grads_in_input_dtype():
    """bf16 in, bf16 gradients out (as _make_core.bwd casts them), and the
    values are the plain backward's, rounded."""
    args = _bf16(_inputs(1, 8, 128, 3, seed=70))
    g = torch.from_numpy(_upstream(1, 128, 71))
    xs = [t.clone().requires_grad_() for t in args]
    out = tpw.pairwise_core(*xs, inject=2, pair_keep=0.5, seed=_seed(3))
    assert out.dtype == torch.float32
    (out * g).sum().backward()
    want = tpw.pairwise_core_bwd_reference(*args, g, 2, 0.5, _seed(3))
    for name, x, w in zip(GRAD_NAMES, xs, want):
        assert x.grad.dtype == torch.bfloat16, name
        torch.testing.assert_close(x.grad, w.to(torch.bfloat16), rtol=0, atol=0, msg=name)


def test_fused_pairwise_g_gradients_match_jax():
    """End to end through the projections: gradients w.r.t. x, q and every
    g weight and bias, fp32, at inject 1 (W_1 split by rows)."""
    x, q, gw, gb = _g_weights(10, 12, 128, 3, 1, seed=80)
    r = _upstream(2, 128, 81)

    def jloss(x, q, gw, gb):
        out = jpw.fused_pairwise_g(x, q, gw, gb, inject=1, dtype=jnp.float32, interpret=True)
        return (out * jnp.asarray(r)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(q), [jnp.asarray(w) for w in gw], [jnp.asarray(b) for b in gb]
    )
    tx, tq = torch.from_numpy(x).requires_grad_(), torch.from_numpy(q).requires_grad_()
    tw = [t.requires_grad_() for t in _t(gw)]
    tb = [t.requires_grad_() for t in _t(gb)]
    (tpw.fused_pairwise_g(tx, tq, tw, tb, inject=1, dtype=torch.float32) * torch.from_numpy(r)).sum().backward()
    got = [tx.grad, tq.grad, *[t.grad for t in tw], *[t.grad for t in tb]]
    flat_want = [want[0], want[1], *want[2], *want[3]]
    for k, (w, d) in enumerate(zip(flat_want, got)):
        np.testing.assert_allclose(d.numpy(), np.asarray(w), rtol=5e-4, atol=5e-3, err_msg=str(k))


# ---------------------------------------------------------------------------
# The Philox pair mask
# ---------------------------------------------------------------------------


def test_philox_matches_known_answer():
    """Philox4x32-10 at counter 0, key 0: first word 0x6627e8d5, the
    known-answer vector of the Random123 reference implementation."""
    z = torch.zeros(1, dtype=torch.int64)
    assert int(tpw.philox_word(z, z, z)[0]) == 0x6627E8D5


def test_pair_mask_rate_and_seed():
    """Keep rate within 5 sigma of the binomial; another seed, another mask;
    the same seed, the same mask."""
    keep, B, n = 0.75, 8, 64
    m = tpw.pair_mask_reference(_seed(7), B, n, n, keep)
    assert m.shape == (B, n * n) and m.dtype == torch.bool
    total = m.numel()
    assert abs(m.float().mean().item() - keep) < 5 * (keep * (1 - keep) / total) ** 0.5
    assert torch.equal(m, tpw.pair_mask_reference(_seed(7), B, n, n, keep))
    other = tpw.pair_mask_reference(_seed(8), B, n, n, keep)
    assert (m != other).float().mean().item() > 0.2
    # the 64-bit seed's high word is part of the key
    high = tpw.pair_mask_reference(torch.tensor([7 + (1 << 40)]), B, n, n, keep)
    assert not torch.equal(m, high)


def test_pair_mask_does_not_depend_on_blocking():
    """The bits of pair (b, i, j) come from (seed, b, i*nj + j) alone: any
    block of rows or samples, drawn on its own, gives the same bits as the
    whole mask — whatever rows a kernel's CTA takes."""
    seed = _seed(99)
    full = tpw.pair_mask_reference(seed, 6, 12, 10, 0.6)
    for b0, b1, p0, p1 in [(0, 6, 0, 120), (2, 5, 37, 101), (5, 6, 119, 120)]:
        p = torch.arange(p0, p1, dtype=torch.int64)[None, :].expand(b1 - b0, -1)
        b = torch.arange(b0, b1, dtype=torch.int64)[:, None].expand(-1, p1 - p0)
        thr, _ = tpw.keep_threshold(0.6)
        block = (tpw.philox_word(p, b, seed.reshape(1, 1)) >> 8) < thr
        assert torch.equal(block, full[b0:b1, p0:p1])
    # a smaller batch is a prefix of a larger one
    assert torch.equal(tpw.pair_mask_reference(seed, 3, 12, 10, 0.6), full[:3])


def test_pair_dropout_forward_scales_kept_pairs():
    """The plain forward under pair dropout pools the kept pairs' rows times
    fp32(1/keep), and a dropped pair contributes nothing."""
    args = _t(_inputs(2, 8, 128, 3, seed=90))
    keep = 0.5
    out = tpw.pairwise_core_reference(*args, 0, keep, _seed(4))
    rows = tpw._recompute(*args, 0)[-1]
    mask = tpw.pair_mask_reference(_seed(4), 2, 8, 8, keep)
    want = (rows * mask[..., None].float()).sum(dim=1) * 2.0
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-5)
    assert not torch.allclose(out, tpw.pairwise_core_reference(*args, 0))


def test_keep_threshold_is_exact():
    """(bits >> 8) < thr is the same test as (bits >> 8) * 2^-24 < keep."""
    for keep in (0.5, 0.75, 0.9, 1 / 3, 1.0):
        thr, inv = tpw.keep_threshold(keep)
        k32 = np.float32(keep)
        for x in (thr - 1, thr):
            assert (np.float32(x) * np.float32(2.0**-24) < k32) == (x < thr)
        assert inv == np.float32(1.0 / keep)


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    args = _bf16(_inputs(1, 8, 128, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpw.pairwise_bwd_cuda(*args, torch.zeros(1, 128), inject=0)
    with pytest.raises(ValueError, match="fp32"):
        tpw.pairwise_bwd_cuda(*args, torch.zeros(1, 128, dtype=torch.bfloat16), inject=0)


def test_build_without_toolkit_raises(monkeypatch, tmp_path):
    """No nvcc: building the kernel raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load(tpw.KERNEL)


def test_library_name_tracks_source(monkeypatch, tmp_path):
    """An edited source gets a new library name, so a stale build is never
    loaded; the flags target Hopper's sm_90a."""
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = build.library_path("k")
    src.write_text("// v2\n")
    assert build.library_path("k") != first
    assert first.startswith(build.BUILD_DIR) and first.endswith(".so")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_library_name_tracks_defines(monkeypatch, tmp_path):
    """A compile-time define (the pairwise kernels' phase-timing build) gets
    a library and a build log of its own, so one variant never loads for
    another; the name is stable for the same defines."""
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text("// v1\n")
    plain = build.library_path("k")
    timed = build.library_path("k", tpw.PHASE_DEFINES)
    assert timed != plain and timed == build.library_path("k", tuple(tpw.PHASE_DEFINES))
    assert build.library_path("k", ("OTHER",)) not in (plain, timed)
    assert build.log_path("k", tpw.PHASE_DEFINES) != build.log_path("k")


def test_phase_buffer_is_checked_before_any_launch():
    """The phase-timing build is asked for through an int64 (grid, 8) buffer;
    on CPU tensors the wrappers refuse before they look at it."""
    args = _bf16(_inputs(1, 8, 128, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpw.pairwise_fwd_cuda(*args, inject=0, phases=torch.zeros(1, tpw.PHASE_SLOTS, dtype=torch.int64))
    assert len(tpw.FWD_PHASES) <= tpw.PHASE_SLOTS and len(tpw.BWD_PHASES) <= tpw.PHASE_SLOTS
