"""rnet_torch models vs rnet models on the same weights, in fp32 on the CPU.

Weights come from the JAX modules' ``init`` and are carried into the port
with ``rnet_torch.convert``; inputs are seeded numpy arrays handed to both.
Per module (conv with non-trivial BatchNorm statistics, the LSTM with
leading and trailing pads, the relational core per impl/injection/pool) and
for the full RN in shrunk original-fp, ir-fp, original-sd and ir-sd configs.
Also: the ``auto`` rule, configs, vocab and encoders agree with rnet's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnet.config import list_models as jax_list_models
from rnet.config import load_config as jax_load_config
from rnet.data.clevr import ImageTransform as JaxImageTransform
from rnet.data.clevr import scene_to_objects as jax_scene_to_objects
from rnet.data.vocab import build_dictionaries as jax_build_dictionaries
from rnet.data.vocab import tokenize as jax_tokenize
from rnet.models import RN as JaxRN
from rnet.models.conv import ConvInputModel as JaxConv
from rnet.models.relational import RelationalLayer as JaxRelational
from rnet.models.text import QuestionEmbedModel as JaxText
from rnet_torch import convert
from rnet_torch.config import load_config
from rnet_torch.data.clevr import ImageTransform, scene_to_objects
from rnet_torch.data.vocab import build_dictionaries, tokenize
from rnet_torch.models import RN
from rnet_torch.models.conv import ConvInputModel
from rnet_torch.models.relational import RelationalLayer
from rnet_torch.models.text import QuestionEmbedModel

torch.set_num_threads(1)

V = 40


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables, prefix=""):
    """Carry flax variables into a port module through rnet_torch.convert."""
    sd = convert.flax_to_state_dict(variables)
    if prefix:
        sd = {k[len(prefix) + 1 :]: v for k, v in sd.items() if k.startswith(prefix + ".")}
    module.load_state_dict(sd)
    return module.eval()


def test_conv_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.rand(2, 32, 32, 3).astype(np.float32)
    m = JaxConv(dtype=jnp.float32)
    variables = _np_tree(m.init(jax.random.key(0), jnp.asarray(x), train=False))
    for name in variables["batch_stats"]:
        c = variables["batch_stats"][name]["mean"].shape[0]
        variables["batch_stats"][name] = {
            "mean": rs.uniform(-0.5, 0.5, c).astype(np.float32),
            "var": rs.uniform(0.5, 1.5, c).astype(np.float32),
        }
        variables["params"][name] = {
            "scale": rs.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rs.uniform(-0.2, 0.2, c).astype(np.float32),
        }
    want = m.apply(variables, jnp.asarray(x), train=False)
    port = _load(
        ConvInputModel(dtype=torch.float32),
        {"params": {"conv": variables["params"]}, "batch_stats": {"conv": variables["batch_stats"]}},
        prefix="conv",
    )
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 2, 2, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mask_pads", [True, False])
@pytest.mark.parametrize("pads", ["trailing", "leading"])
def test_text_matches_jax(pads, mask_pads):
    tokens = np.array([[3, 9, 2, 7, 0, 0], [5, 1, 0, 0, 0, 0], [4, 4, 8, 1, 2, 6]], dtype=np.int32)
    if pads == "leading":  # inverted questions, the serving default
        tokens = np.ascontiguousarray(tokens[:, ::-1])
    m = JaxText(vocab_size=V, emb_dim=8, hidden=16, mask_pads=mask_pads)
    variables = _np_tree(m.init(jax.random.key(1), jnp.asarray(tokens)))
    want = m.apply(variables, jnp.asarray(tokens))
    port = _load(QuestionEmbedModel(V, 8, 16, mask_pads=mask_pads), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _relational_pair(impl, inject, pool, g_layers=(32, 32, 32), object_mask=False):
    kw = dict(
        obj_dim=7, q_dim=12, g_layers=g_layers, f_layers=(24,), n_answers=9,
        question_injection_position=inject, pair_pool=pool, object_mask=object_mask, impl=impl,
    )
    jm = JaxRelational(dropout=0.0, dtype=jnp.float32, **kw)
    return jm, RelationalLayer(dtype=torch.float32, **kw)


@pytest.mark.parametrize("pool", ["sum", "mean"])
@pytest.mark.parametrize("inject", [0, 1])
@pytest.mark.parametrize("impl", ["naive", "xla"])
def test_relational_matches_jax(impl, inject, pool):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 7).astype(np.float32)
    q = rs.randn(2, 12).astype(np.float32)
    jm, tm = _relational_pair(impl, inject, pool)
    variables = _np_tree(jm.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(q)))
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(q))
    port = _load(tm, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("inject", [0, 2])
def test_relational_kernel_impl_matches_jax(inject):
    """impl='pallas' at a kernel shape: the plain version on the CPU vs
    rnet's pallas impl (its jnp reference off-TPU)."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 32, 7).astype(np.float32)
    q = rs.randn(2, 12).astype(np.float32)
    jm, tm = _relational_pair("pallas", inject, "sum", g_layers=(128, 128, 128))
    variables = _np_tree(jm.init(jax.random.key(3), jnp.asarray(x), jnp.asarray(q)))
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(q))
    port = _load(tm, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_relational_object_mask_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(3, 6, 7).astype(np.float32)
    q = rs.randn(3, 12).astype(np.float32)
    n_obj = np.array([6, 2, 4], dtype=np.int32)
    jm, tm = _relational_pair("xla", 0, "sum", object_mask=True)
    variables = _np_tree(
        jm.init(jax.random.key(4), jnp.asarray(x), jnp.asarray(q), n_objects=jnp.asarray(n_obj))
    )
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(q), n_objects=jnp.asarray(n_obj))
    port = _load(tm, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(q), n_objects=torch.from_numpy(n_obj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="n_objects"):
        port(torch.from_numpy(x), torch.from_numpy(q))
    port.impl = "pallas"
    with pytest.raises(ValueError, match="naive/xla"):
        port(torch.from_numpy(x), torch.from_numpy(q), n_objects=torch.from_numpy(n_obj))


def _shrunk(name):
    """Shrunk configs in the manner of tests/test_oracle_parity.py."""
    over = {"compute_dtype": "float32"}
    if name.endswith("-fp"):
        kw = dict(image_size=32, g_layers=(48, 48, 48, 48), f_layers=(32, 32),
                  lstm_hidden=24, lstm_word_emb=8, dropout=0.0)
    else:
        kw = dict(g_layers=(48, 48, 48), f_layers=(32,), lstm_hidden=24,
                  lstm_word_emb=8, dropout=0.0, max_objects=6)
    return jax_load_config(name, overrides=over).replace(**kw), load_config(name, overrides=over).replace(**kw)


@pytest.mark.parametrize("name", ["original-fp", "ir-fp", "original-sd", "ir-sd"])
def test_full_rn_matches_jax(name):
    jcfg, tcfg = _shrunk(name)
    rs = np.random.RandomState(5)
    B = 3
    if tcfg.state_description:
        inputs = rs.randn(B, tcfg.max_objects, tcfg.object_dim).astype(np.float32)
        inputs[:, 4:] = 0.0  # pad objects participate as zero vectors
        rtol, atol = 1e-4, 1e-5
    else:
        inputs = rs.randint(0, 256, size=(B, 32, 32, 3)).astype(np.uint8)
        rtol, atol = 1e-3, 1e-4
    tokens = rs.randint(1, V, size=(B, 12)).astype(np.int32)
    tokens[:, :4] = 0  # leading pads (inverted questions)
    jm = JaxRN(cfg=jcfg, vocab_size=V)
    variables = _np_tree(jm.init(jax.random.key(6), jnp.asarray(inputs), jnp.asarray(tokens)))
    want = jm.apply(variables, jnp.asarray(inputs), jnp.asarray(tokens), train=False)
    port = _load(RN(tcfg, V), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(inputs), torch.from_numpy(tokens))
    assert tuple(got.shape) == (B, tcfg.n_answers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("pad", [8, 5])
def test_padded_eval_matches_jax(pad):
    """Eval on padded canvases (the cached/device pipelines' val cache):
    both packages center-crop at (S - image_size) // 2, cast, divide by 255."""
    jcfg, tcfg = _shrunk("original-fp")
    rs = np.random.RandomState(8)
    S = 32 + 2 * pad
    inputs = rs.randint(0, 256, size=(3, S, S, 3)).astype(np.uint8)
    tokens = rs.randint(1, V, size=(3, 12)).astype(np.int32)
    jm = JaxRN(cfg=jcfg, vocab_size=V)
    variables = _np_tree(jm.init(jax.random.key(9), jnp.asarray(inputs[:, :32, :32]), jnp.asarray(tokens)))
    want = jm.apply(variables, jnp.asarray(inputs), jnp.asarray(tokens), train=False)
    port = _load(RN(tcfg, V), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(inputs), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["original-fp", "original-sd"])
def test_convert_round_trip_is_exact(name):
    """flax -> torch state_dict -> flax returns the same arrays, and the
    state_dict fills the port model exactly (strict load)."""
    jcfg, tcfg = _shrunk(name)
    shape = (1, tcfg.max_objects, tcfg.object_dim) if tcfg.state_description else (1, 32, 32, 3)
    jm = JaxRN(cfg=jcfg, vocab_size=V)
    variables = _np_tree(jm.init(jax.random.key(7), jnp.zeros(shape), jnp.ones((1, 12), jnp.int32)))
    variables.setdefault("batch_stats", {})
    sd = convert.flax_to_state_dict(variables)
    RN(tcfg, V).load_state_dict(sd)
    back = convert.state_dict_to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_a] == [jax.tree_util.keystr(k) for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(k)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "name, device, dtype, want",
    [
        ("original-fp", "cuda", "bfloat16", "pallas"),
        ("ir-fp", "cuda", "bfloat16", "pallas"),
        ("wide-fp", "cuda", "bfloat16", "pallas"),
        ("stretch-fp-16", "cuda", "bfloat16", "pallas"),
        ("original-sd", "cuda", "bfloat16", "xla"),  # n = 12 < 32
        ("original-fp", "cuda", "float32", "xla"),
        ("original-fp", "cpu", "bfloat16", "xla"),
    ],
)
def test_auto_impl_rule(name, device, dtype, want):
    """The kernel is on the path exactly where rnet would use Pallas on a
    TPU (n >= 32, uniform widths, multiple of 128) — here on CUDA in bf16."""
    cfg = load_config(name, overrides={"compute_dtype": dtype})
    m = RN(cfg, V)
    assert m.relational.resolve_impl(cfg.n_objects, torch.device(device)) == want


def test_int8_impl_not_ported_raises():
    """pallas_int8 resolves now (the int8 kernel is ported); what it still
    refuses raises: int8 with fp32 compute on the card (ROADMAP.md), and the
    object mask, which needs the naive/xla impl as pallas does."""
    from rnet_torch.kernels import pairwise as tpw

    cfg = load_config("original-fp", overrides={"rl_impl": "pallas_int8"})
    assert RN(cfg, V).relational.resolve_impl(cfg.n_objects, torch.device("cpu")) == "pallas_int8"
    rs = np.random.RandomState(6)
    args = [torch.from_numpy(rs.randn(*shape).astype(np.float32))
            for shape in ((2, 16, 128), (2, 16, 128), (2, 128), (2, 128), (2, 128, 128), (2, 128))]
    u, v, s, qa, w8, m, bs = tpw.quantize_int8(*args, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpw.pairwise_fwd_int8_cuda(u, v, s, qa, w8, m, bs, inject=0)  # fp32 u, v, s
    jm, tm = _relational_pair("pallas_int8", 0, "sum", object_mask=True)
    x, q = torch.from_numpy(rs.randn(2, 6, 7).astype(np.float32)), torch.from_numpy(rs.randn(2, 12).astype(np.float32))
    with pytest.raises(ValueError, match="naive/xla"):
        tm.eval()(x, q, n_objects=torch.tensor([6, 3]))


def test_training_forward_not_ported_raises():
    """The training forward with its device augmentation (random crop +
    rotation) runs and draws from the generator, which it needs: without
    one it raises instead of silently skipping the augmentation. Padded
    canvases are center-cropped where no augmentation applies (train without
    device_augment, and eval)."""
    _, tcfg = _shrunk("original-fp")
    q = torch.ones(2, 4, dtype=torch.int32)
    canvas = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (2, 40, 40, 3)).astype(np.uint8))
    m = RN(tcfg.replace(device_augment=True), V)  # nn.Module default: training mode
    with pytest.raises(ValueError, match="Generator"):
        m(canvas, q)
    a = m(canvas, q, generator=torch.Generator().manual_seed(1))
    b = m(canvas, q, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all()
    center = canvas[:, 4:36, 4:36]
    torch.testing.assert_close(m.eval()(canvas, q), m(center, q), rtol=0, atol=0)
    m = RN(tcfg, V)
    torch.testing.assert_close(m(canvas, q), m(center, q), rtol=0, atol=0)  # the train forward itself runs


def test_configs_match_rnet():
    names = jax_list_models()
    assert names
    for name in names:
        assert dataclasses.asdict(load_config(name)) == dataclasses.asdict(jax_load_config(name)), name


def test_vocab_and_encoders_match_rnet(fixture_dir, tmp_path):
    import json
    import os

    from PIL import Image

    mine = build_dictionaries(fixture_dir, use_cache=False)
    ref = jax_build_dictionaries(fixture_dir, use_cache=False)
    assert mine.word_to_idx == ref.word_to_idx and mine.answer_to_idx == ref.answer_to_idx
    with open(os.path.join(fixture_dir, "questions", "CLEVR_val_questions.json")) as f:
        qs = json.load(f)["questions"]
    with open(os.path.join(fixture_dir, "scenes", "CLEVR_val_scenes.json")) as f:
        scenes = json.load(f)["scenes"]
    for q in qs:
        assert tokenize(q["question"]) == jax_tokenize(q["question"])
        np.testing.assert_array_equal(mine.encode_question(q["question"], 48), ref.encode_question(q["question"], 48))
    for s in scenes:
        np.testing.assert_array_equal(scene_to_objects(s["objects"], 12), jax_scene_to_objects(s["objects"], 12))
    img_path = os.path.join(fixture_dir, "images", "val", qs[0]["image_filename"])
    with Image.open(img_path) as im:
        np.testing.assert_array_equal(ImageTransform(128)(im), JaxImageTransform(128, train=False)(im))
