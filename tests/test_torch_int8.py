"""The port's int8 inference path vs rnet's, on the CPU.

rnet's int8 Pallas kernel runs in interpret mode (``_fwd_pallas_int8(...,
interpret=True)``), and the port's plain int8 version (the CPU path of
``pairwise_core_int8``) must match it within 1e-5 of max|rnet|: both fold
the scales with the same dtypes, so the int8 codes agree and only the
order of the fp32 sums differs. Also: the calibration scales and the clip
fractions against rnet's, the drift of int8 from the fp32 reference, the
loud fallbacks and refusals (twins of tests/test_kernel.py), the shape
predicate against ``_supported``, and the full RN in int8 against rnet's RN
with its kernel in interpret mode.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnet.config import load_config as jax_load_config
from rnet.kernels import pairwise as rpw
from rnet.models import RN as JaxRN
from rnet.models.relational import RelationalLayer as JaxRelational
from rnet_torch import convert
from rnet_torch.config import load_config
from rnet_torch.kernels import pairwise as tpw
from rnet_torch.models import RN
from rnet_torch.models.relational import RelationalLayer

torch.set_num_threads(1)

V = 40


def _inputs(B, ni, nj, H, L, seed):
    """Seeded fp32 numpy inputs (u, v, s, qa, ws, bs) of the pairwise core,
    scaled as tests/test_kernel.py's."""
    rs = np.random.RandomState(seed)
    arrs = (rs.randn(B, ni, H) * 0.3, rs.randn(B, nj, H) * 0.3, rs.randn(B, H) * 0.1, rs.randn(B, H) * 0.1,
            rs.randn(L - 1, H, H) / np.sqrt(H), rs.randn(L - 1, H) * 0.05)
    return [a.astype(np.float32) for a in arrs]


def _both(arrs, dtype):
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


@pytest.mark.parametrize(
    "B, ni, nj, H, L, inject, dtype",
    [
        (2, 16, 16, 128, 3, 0, "bfloat16"),
        (3, 24, 24, 128, 4, 2, "bfloat16"),
        (5, 64, 64, 256, 4, 0, "bfloat16"),
        (2, 16, 16, 128, 4, 1, "float32"),
        (2, 16, 32, 128, 3, 1, "bfloat16"),  # rectangular nj != ni
    ],
)
def test_int8_core_matches_rnet_interpret(B, ni, nj, H, L, inject, dtype):
    """Calibration, folding and the int8 chain against rnet's kernel in
    interpret mode. Limit 1e-5 * max|rnet|: the codes agree bit for bit, the
    pooled fp32 sum is taken in another order."""
    j, t = _both(_inputs(B, ni, nj, H, L, seed=B * 100 + ni), dtype)
    want = np.asarray(rpw._fwd_pallas_int8(*j, inject, True))
    got = tpw.pairwise_core_int8(*t, inject=inject)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H) and not got.requires_grad
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("B", [1, 3, 5, 8])
def test_activation_scales_match_rnet(B):
    """Ceil strides over batch and objects; the reshape follows the actual
    number of strided rows (B=5 gives 3), the inject term included."""
    j, t = _both(_inputs(B, 24, 24, 128, 4, seed=B), "float32")
    want = np.asarray(rpw._activation_scales(*j, 2))
    got = tpw.activation_scales(*t, 2).numpy()
    assert got.shape == (3,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_activation_scales_exact_when_fully_sampled():
    """B <= 4 and n <= 16: the subsample is the whole input, so the scales
    are margin x the true per-layer maxima (test_kernel.py:256)."""
    u, v, s, qa, ws, bs = (torch.from_numpy(a) for a in _inputs(3, 16, 16, 128, 3, seed=0))
    sc = tpw.activation_scales(u, v, s, qa, ws, bs, 2, margin=1.0)
    a = torch.relu(u[:, :, None] + v[:, None] + s[:, None, None]).reshape(3, -1, 128)
    true = [a.max(), torch.relu(a @ ws[0] + bs[0]).max()]
    torch.testing.assert_close(sc, torch.stack(true), rtol=1e-6, atol=0)


def test_int8_clip_fractions_match_rnet():
    """Equal to rnet's on the cases of test_kernel.py:278: zero under a huge
    margin, positive under a sub-unity one, rectangular and irregular."""
    cases = [
        (_inputs(8, 64, 64, 128, 3, seed=1), 2, 100.0),
        (_inputs(8, 64, 64, 128, 3, seed=1), 2, 1e-3),
        (_inputs(8, 64, 32, 128, 3, seed=2), 0, 1.2),  # nj != ni
        (_inputs(5, 24, 24, 128, 3, seed=3), 2, 1.2),  # B=5: 3 strided rows
        (_inputs(8, 64, 64, 256, 4, seed=4), 0, 0.8),
    ]
    fracs = []
    for arrs, inject, margin in cases:
        j, t = _both(arrs, "float32")
        want = np.asarray(rpw.int8_clip_fractions(*j, inject, margin=margin))
        got = tpw.int8_clip_fractions(*t, inject, margin=margin).numpy()
        assert got.shape == want.shape and np.all(np.isfinite(got))
        np.testing.assert_array_equal(got, want)
        fracs.append(got)
    assert np.all(fracs[0] == 0.0) and fracs[1].max() > 0.0 and fracs[4].max() > 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_drift_from_fp32_reference(dtype):
    """At original-fp's widths (n=64, H=256, L=4), B=8: int8 stays within
    3e-2 of the fp32 reference, the bound of test_kernel.py:370."""
    arrs = _inputs(8, 64, 64, 256, 4, seed=7)
    _, t = _both(arrs, dtype)
    got = tpw.pairwise_core_int8(*t, inject=0)
    ref = tpw.pairwise_core_reference(*(torch.from_numpy(a) for a in arrs), inject=0)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel < 3e-2, rel


def test_requant_truncates_as_astype():
    a = np.array([0.0, 0.2, 0.49, 0.5, 0.51, 1.5, 2.4999, 126.4, 126.5, 126.6, 200.0, 1e9], np.float32)
    want = np.asarray(jnp.minimum(jnp.asarray(a) + 0.5, 127.0).astype(jnp.int8))
    np.testing.assert_array_equal(tpw._requant(torch.from_numpy(a)).numpy(), want)


def test_int8_shape_predicate_matches_rnet():
    for ni in (4, 8, 12, 16, 24, 64, 128, 200, 256):
        for nj in (4, 12, 16, 32, 64, 200, 256):
            for H in (64, 128, 256, 512):
                for L in (1, 2, 4):
                    assert tpw.int8_supported(ni, nj, H, L) == rpw._supported(ni, nj, H, L), (ni, nj, H, L)


def test_int8_unsupported_shape_falls_back_loudly():
    """n=12 is not tileable: a "NOT int8" warning and the fp reference, as
    test_kernel.py:299 asks of rnet."""
    args = [torch.from_numpy(a) for a in _inputs(2, 12, 12, 128, 3, seed=0)]
    with pytest.warns(UserWarning, match="NOT int8"):
        out = tpw.pairwise_core_int8(*args, inject=0)
    torch.testing.assert_close(out, tpw.pairwise_core_reference(*args, inject=0), rtol=1e-6, atol=0)


def test_int8_with_pair_dropout_raises():
    x, q = torch.randn(2, 8, 4), torch.randn(2, 6)
    gw, gb = [torch.zeros(14, 32), torch.zeros(32, 32)], [torch.zeros(32), torch.zeros(32)]
    with pytest.raises(ValueError, match="inference-only"):
        tpw.fused_pairwise_g(x, q, gw, gb, inject=0, int8=True, pair_keep=0.5, seed=torch.zeros(1, dtype=torch.int64))


def test_int8_train_request_warns():
    """Train mode runs the bf16 kernel path, loudly (test_kernel.py:325);
    eval mode runs int8 without a warning."""
    layer = RelationalLayer(obj_dim=8, q_dim=12, g_layers=(128,) * 3, f_layers=(64,), n_answers=5,
                            dropout=0.0, impl="pallas_int8", dtype=torch.float32)
    x, q = torch.randn(4, 16, 8), torch.randn(4, 12)
    assert layer.resolve_impl(16, x.device) == "pallas_int8"
    with pytest.warns(UserWarning, match="inference-only"):
        y = layer.train()(x, q)
    bf = RelationalLayer(obj_dim=8, q_dim=12, g_layers=(128,) * 3, f_layers=(64,), n_answers=5,
                         dropout=0.0, impl="pallas", dtype=torch.float32)
    bf.load_state_dict(layer.state_dict())
    torch.testing.assert_close(y, bf.train()(x, q), rtol=0, atol=0)  # the pallas path itself
    layer.eval()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            y8 = layer(x, q)
    assert tuple(y8.shape) == (4, 5) and torch.isfinite(y8).all()


def test_relational_int8_clip_report_method():
    """The drift diagnostic at the layer (test_kernel.py:341): B=5, n=12."""
    jm = JaxRelational(obj_dim=8, q_dim=12, g_layers=(128,) * 3, f_layers=(64,), n_answers=5,
                       question_injection_position=2, dropout=0.0, dtype=jnp.float32)
    rs = np.random.RandomState(5)
    x, q = rs.randn(5, 12, 8).astype(np.float32), rs.randn(5, 12).astype(np.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(q)))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(q), method=JaxRelational.int8_clip_report))
    tm = RelationalLayer(obj_dim=8, q_dim=12, g_layers=(128,) * 3, f_layers=(64,), n_answers=5,
                         question_injection_position=2, dropout=0.0, dtype=torch.float32)
    tm.load_state_dict(convert.flax_to_state_dict(variables))
    got = tm.int8_clip_report(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    assert got.shape == (2,) and np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, want)


def test_int8_wrapper_refuses_what_the_kernel_does_not_take():
    folded = tpw.quantize_int8(*(torch.from_numpy(a).bfloat16() for a in _inputs(2, 16, 16, 128, 3, seed=0)), 0)
    with pytest.raises(ValueError, match="CUDA"):
        tpw.pairwise_fwd_int8_cuda(*folded, inject=0)  # CPU tensors
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpw.pairwise_fwd_int8_cuda(*(t.float() if k < 3 else t for k, t in enumerate(folded)), inject=0)
    u, v, s, qa, w8, m, bs = folded
    with pytest.raises(ValueError, match="w8"):
        tpw.pairwise_fwd_int8_cuda(u, v, s, qa, w8.float(), m, bs, inject=0)
    with pytest.raises(ValueError, match="H % 128"):
        tpw.pairwise_fwd_int8_cuda(u[..., :64].contiguous(), v[..., :64].contiguous(), s[:, :64].contiguous(),
                                   qa[:, :64].contiguous(), w8[:, :64, :64].contiguous(), m,
                                   bs[:, :64].contiguous(), inject=0)
    with pytest.raises(ValueError, match="qa"):
        tpw.pairwise_fwd_int8_cuda(u, v, s, qa[:1], w8, m, bs, inject=0)


def _int8_cfgs(name):
    """original-fp / ir-fp shrunk to a shape the int8 kernel takes: 32x32
    images through 3 convs (a 4x4 grid, n=16), g of 4 x 128, in fp32."""
    over = {"compute_dtype": "float32", "rl_impl": "pallas_int8"}
    kw = dict(image_size=32, conv_channels=(24, 24, 24), g_layers=(128,) * 4, f_layers=(32, 32),
              lstm_hidden=24, lstm_word_emb=8, dropout=0.0)
    return jax_load_config(name, overrides=over).replace(**kw), load_config(name, overrides=over).replace(**kw)


@pytest.mark.parametrize("name", ["original-fp", "ir-fp"])
def test_rn_int8_matches_rnet(name, monkeypatch):
    """Full RN log-probs and the clip report in int8 against rnet's RN, whose
    int8 kernel runs in interpret mode (off a TPU rnet would fall back to
    fp). Limit: rtol 1e-5, atol 1e-5: the two conv stems differ by ~1e-6,
    which moves no int8 code at these inputs (the gap is ~2e-6)."""
    orig = rpw.pairwise_core_int8
    monkeypatch.setattr(rpw, "pairwise_core_int8",
                        lambda *a, inject, interpret=False: orig(*a, inject=inject, interpret=True))
    jcfg, tcfg = _int8_cfgs(name)
    rs = np.random.RandomState(11)  # B=5: the probe rows (1, 3) are not the calibration's (0, 2, 4)
    inputs = rs.randint(0, 256, size=(5, 32, 32, 3)).astype(np.uint8)
    tokens = rs.randint(1, V, size=(5, 12)).astype(np.int32)
    tokens[:, :4] = 0
    jm = JaxRN(cfg=jcfg, vocab_size=V)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(6), jnp.asarray(inputs), jnp.asarray(tokens)))
    want = np.asarray(jm.apply(variables, jnp.asarray(inputs), jnp.asarray(tokens), train=False))
    want_fr = np.asarray(jm.apply(variables, jnp.asarray(inputs), jnp.asarray(tokens), method=JaxRN.int8_clip_report))
    port = RN(tcfg, V)
    port.load_state_dict(convert.flax_to_state_dict(variables))
    port.eval()
    assert port.cfg.n_objects == 16
    with torch.no_grad():
        got = port(torch.from_numpy(inputs), torch.from_numpy(tokens)).numpy()
    fr = port.int8_clip_report(torch.from_numpy(inputs), torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert fr.shape == (3,)
    np.testing.assert_allclose(fr, want_fr, atol=1.0 / (3 * 16 * 16 * 128))  # one probe value of 3x256x128
