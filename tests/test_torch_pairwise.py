"""rnet_torch.kernels.pairwise vs rnet.kernels.pairwise on the CPU.

On CPU tensors the port's ``pairwise_core`` takes its plain version; it is
held to rnet's jnp reference and to the Pallas kernel in interpret mode (as
tests/test_kernel.py runs it), at the tolerances of test_kernel.py. The CUDA
kernel itself runs only on the card (chip_smoke.py); here its wrapper's
refusals are checked: wrong dtype, shape or device, and a missing toolkit.
"""

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
    with pytest.raises(NotImplementedError, match="pair dropout"):
        tpw.pairwise_core(*_t(_inputs(1, 8, 128, 3)), inject=0, pair_keep=0.5)


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
