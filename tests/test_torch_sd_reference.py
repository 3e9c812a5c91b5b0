"""The port's state-description RN (``original-sd`` at its full widths)
against the benchmark's plain reference, ``portbench/reference_sd.py``, on
the CPU in fp32; the ``g_xla`` route counter; the SD FLOP model
(``portbench/ops_sd.py``); and the two readers of the ``osd.train.b640``
cell on a synthetic trace slice."""

from __future__ import annotations

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import core, ops, ops_sd, readers, reference_sd  # noqa: E402
from portbench.trace import Slice  # noqa: E402
from rnet_torch.config import load_config  # noqa: E402
from rnet_torch.kernels import pairwise  # noqa: E402
from rnet_torch.models import RN  # noqa: E402
from rnet_torch.train import steps  # noqa: E402

VOCAB = 90
B = 4
SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def widths():
    return core.resolve_cell("osd.train.b640").config["widths"]


def sd_batch(n_q: int, seed: int):
    """Objects of scenes with 3-10 real objects (zero rows after them),
    tokens with the pads first, answers."""
    g = torch.Generator().manual_seed(seed)
    counts = torch.randint(3, 11, (n_q,), generator=g)
    objs = torch.zeros(n_q, 12, 18)
    for b, k in enumerate(counts.tolist()):
        objs[b, :k, :3] = torch.rand(k, 3, generator=g) * 2 - 1
        for a, width in ((3, 8), (11, 3), (14, 2), (16, 2)):
            objs[b, torch.arange(k), a + torch.randint(0, width, (k,), generator=g)] = 1.0
    lengths = torch.randint(4, 49, (n_q,), generator=g)
    tokens = torch.randint(1, VOCAB, (n_q, 48), generator=g, dtype=torch.int32)
    tokens = torch.where(torch.arange(48)[None, :] >= 48 - lengths[:, None], tokens, 0)
    answers = torch.randint(0, 28, (n_q,), generator=g, dtype=torch.int32)
    return {"objects": objs, "n_objects": counts.to(torch.int32), "question": tokens, "answer": answers}


def port_model(impl: str, weights):
    cfg = load_config("original-sd", overrides={"compute_dtype": "float32", "rl_impl": impl})
    model = RN(cfg, VOCAB)
    with torch.no_grad():
        live = model.state_dict()
        assert sorted(live) == sorted(weights)
        for k, v in live.items():
            v.copy_(weights[k])
    return model


def draw(seed=SEED):
    return reference_sd.draw_weights(widths(), VOCAB, torch.Generator().manual_seed(seed), "cpu")


def rel_norm(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("impl", ["xla", "naive"])
def test_eval_log_probs_match_the_reference(impl):
    w, p, batch = widths(), draw(), sd_batch(B, 1)
    model = port_model(impl, p).eval()
    with torch.no_grad():
        got = model(batch["objects"], batch["question"])
    want = reference_sd.log_probs(p, w, batch["objects"], batch["question"], block=3)
    # fp32 on both sides, the same products summed in other orders (the
    # LSTM's addmm, the naive route's concatenated rows): ~1e-7 relative
    assert rel_err(got, want) <= 1e-5
    assert float(want.exp().sum(-1).sub(1).abs().max()) <= 1e-5
    nll = -want.gather(1, batch["answer"].long()[:, None]).mean()
    assert 2.0 < float(nll) < 6.0  # the drawn weights leave the answers unsaturated


@pytest.mark.parametrize("impl", ["xla", "naive"])
def test_train_loss_and_every_gradient_match_the_reference(impl):
    w, p, batch = widths(), draw(), sd_batch(B, 2)
    model = port_model(impl, p).train()
    gen = torch.Generator().manual_seed(17)
    loss, _, grads = steps.loss_and_grads(model, batch, gen)
    u = reference_sd.step_draws(torch.Generator().manual_seed(17), B, w["f_layers"][-1], "cpu")
    ref_loss, ref_grads = reference_sd.loss_and_grads(p, w, batch["objects"], batch["question"], batch["answer"], u,
                                                      block=3)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for n, g in zip(names, grads):
        # fp32 gradients in other orders of adds: ~1e-6 of the leaf's largest
        assert rel_err(g, ref_grads[n]) <= 1e-4, n


def test_dropout_draws_are_the_reference_step_draws():
    """A changed dropout draw moves the port's loss: the reference only
    agrees because it draws the same uniforms from the same generator."""
    w, p, batch = widths(), draw(), sd_batch(B, 3)
    model = port_model("xla", p).train()
    loss, _, _ = steps.loss_and_grads(model, batch, torch.Generator().manual_seed(17))
    u_other = reference_sd.step_draws(torch.Generator().manual_seed(18), B, w["f_layers"][-1], "cpu")
    other, _ = reference_sd.loss_and_grads(p, w, batch["objects"], batch["question"], batch["answer"], u_other)
    assert abs(float(loss) - float(other)) > 1e-4 * abs(float(other))


@pytest.mark.parametrize("impl", ["xla", "naive"])
def test_a_chunk_of_clipped_adam_steps_matches_the_reference(impl):
    """Three steps of the port's chunked train step (the call the
    Trainer's device loop dispatches) from the reference's weights, with
    a clip below the gradients' norm, against ``reference_sd.train_steps``
    from the same generator seed."""
    w, p = widths(), draw()
    data = sd_batch(3 * B + 5, 4)
    rows = torch.arange(3 * B, dtype=torch.int32).reshape(3, B).flip(1)
    model = port_model(impl, p)
    lr, clip = 1e-3, 0.5
    state = steps.create_train_state(model, steps.make_optimizer(lr, clip), seed=23)
    train_chunk, _ = steps.make_chunked_steps(state, None)
    ms = train_chunk(rows, data, None)
    opt = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "lr": lr, "clip_norm": clip}
    ref = reference_sd.train_steps(p, w, data, list(rows), 23, opt, block=3)
    assert min(ref["grad_norm"]) > clip  # every step clipped
    assert max(abs(a - b) / b for a, b in zip(ms[:, 0].tolist(), ref["loss"])) <= 1e-5
    assert max(abs(a - b) / b for a, b in zip(ms[:, 2].tolist(), ref["grad_norm"])) <= 1e-5
    live = dict(model.named_parameters())
    for n, want in ref["params"].items():
        # Adam divides by sqrt(v), so an element whose gradient is near the
        # fp32 round-off of its sum moves by lr * O(1) either way: its change
        # differs by up to 0.4 % of the largest (3 lr; a wrong sign would be
        # ~70 %), the leaf's change by ~3e-5 of its norm (measured)
        d_port, d_ref = live[n].detach() - p[n], want - p[n]
        assert float((d_port - d_ref).abs().max()) <= 1e-2 * 3 * lr, n
        assert rel_norm(d_port, d_ref) <= 2e-4, n
        got_m = state.adam.state[live[n]]["exp_avg"]
        assert rel_err(got_m, ref["moment"][n]) <= 1e-4, n


def test_g_xla_counts_one_per_call_on_the_xla_route_only():
    p, batch = draw(), sd_batch(B, 5)
    for impl, want in (("xla", 1), ("naive", 0), ("pallas", 0)):
        model = port_model(impl, p).eval()
        pairwise.reset_launches()
        with torch.no_grad():
            model(batch["objects"], batch["question"])
            model(batch["objects"], batch["question"])
        assert pairwise.launches[pairwise.XLA_ROUTE] == 2 * want, impl
        assert all(v == 0 for k, v in pairwise.launches.items() if k != pairwise.XLA_ROUTE)
    model = port_model("auto", p).train()  # 12 objects: auto takes xla
    pairwise.reset_launches()
    steps.loss_and_grads(model, batch, torch.Generator().manual_seed(1))
    assert pairwise.launches[pairwise.XLA_ROUTE] == 1
    pairwise.reset_launches()
    assert pairwise.launches[pairwise.XLA_ROUTE] == 0


def test_g_xla_is_carried_per_replay_of_a_captured_chunk():
    """A chunk's graph counts what its capture counted at every replay
    (the fake capture backend of the graphs tests: the body runs again)."""
    from rnet_torch.train.graphs import StepGraphs

    class Replaying:
        def new_pool(self):
            return None

        def warmup(self):
            import contextlib

            return contextlib.nullcontext()

        def new_graph(self):
            return {}

        def capture(self, graph, pool, generators):
            import contextlib

            return contextlib.nullcontext()

        def replay(self, graph):
            pass

        def reserved_bytes(self):
            return 0

    p, data = draw(), sd_batch(2 * B, 6)
    model = port_model("xla", p)
    state = steps.create_train_state(model, steps.make_optimizer(1e-4, 50.0), seed=3)
    graphs = StepGraphs("cpu", generators=(state.generator,), rollback=steps.StateRollback(state), backend=Replaying())
    chunk, _ = steps.make_chunked_steps(state, graphs)
    rows = torch.arange(2 * B, dtype=torch.int32).reshape(2, B)
    pairwise.reset_launches()
    chunk(rows, data, None)
    chunk(rows, data, None)
    assert pairwise.launches[pairwise.XLA_ROUTE] == 4  # two steps a replay, two replays; capture counted none


def test_sd_flop_model_counted_by_hand():
    w = widths()
    got = {name: (flops, dt) for name, flops, dt in ops_sd.forward_products(w, "bfloat16")}
    assert got == {
        "lstm": (2.0 * 48 * 4 * 256 * (32 + 256), "float32"),
        "g_projections": (2.0 * (2 * 12 * 18 + 256) * 512, "bfloat16"),
        "g1": (2.0 * 144 * 512 * 512, "bfloat16"),
        "g2": (2.0 * 144 * 512 * 512, "bfloat16"),
        "g3": (2.0 * 144 * 512 * 512, "bfloat16"),
        "f_phi": (2.0 * (512 * 512 + 512 * 1024 + 1024 * 28), "float32"),
    }
    least = ops.seconds_at_peak(ops_sd.forward_products(w), 3.0)
    by_hand = 3.0 * ((28311552 + 1630208) / 67e12 + (704512 + 3 * 75497472) / 989e12)
    assert least == pytest.approx(by_hand, rel=1e-12)
    with pytest.raises(ValueError):
        ops_sd.forward_products(dict(w, question_injection_position=1))


# Kernel names as torch.profiler gives them in an H100 trace of the cell's
# step (torch 2.11, CUDA 12.8; long names cut after their element type).
G_KERNELS = [
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT",
    "nvjet_tst_128x128_64x6_2x1_v_bz_splitK_NTT",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float, __nv_bfloat16, false, float, "
    "__nv_bfloat16, __nv_bfloat16, true, false, false, false>",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_32x3_nn_align2>",
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<"
    "c10::BFloat16> >",
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::BFloat16, at::native::func_wrapper_t<"
    "c10::BFloat16, at::native::sum_functor<c10::BFloat16, float, c10::BFloat16>",
    "void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >",
    "pairwise_fwd_kernel",
    "dw_gemm_kernel<2>",
]
OTHER_KERNELS = [
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >",
    "void (anonymous namespace)::indexing_backward_kernel_small_stride<float>(long const*, long const*, "
    "float const*, float*, long, long, long, long, bool)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel"
    "__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_64x128_8x5_nt_align1>(cutlass_80_simt_sgemm_64x128_8x5_nt_align1::"
    "Params)",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, false, float, float, float, true, "
    "false, false, false>",
    "augment_kernel",
    "Memcpy DtoD (Device -> Device)",
]


def _ctx(cell_name, device, steps_=10, batch=640):
    cell = core.resolve_cell(cell_name)
    sl = Slice(0.0, 1e6, device, [])  # a slice of one second
    return readers.Context(cell, sl, {"steps": steps_, "batch_size": batch})


def test_device_ms_g_reader_counts_the_bf16_and_pairwise_kernels():
    read = core.load_reader("device_ms.g.train.sd")
    mod = sys.modules["portbench_metric_device_ms_g_train_sd"]
    assert all(mod.is_g(n) for n in G_KERNELS)
    assert not any(mod.is_g(n) for n in OTHER_KERNELS)
    device = [(n, 1000.0 * k, 1000.0 * k + 250.0) for k, n in enumerate(G_KERNELS)]  # 0.25 ms each
    device += [(n, 100000.0 + 1000.0 * k, 100000.0 + 1000.0 * k + 400.0) for k, n in enumerate(OTHER_KERNELS)]
    assert read(_ctx("osd.train.b640", device, steps_=4)) == pytest.approx(len(G_KERNELS) * 0.25 / 4)
    assert read(_ctx("osd.train.b640", device[len(G_KERNELS):], steps_=4)) == 0.0
    assert read(readers.Context(core.resolve_cell("osd.train.b640"), None, {"steps": 4})) is None
    assert read(_ctx("osd.train.b640", device, steps_=0)) is None


def test_mfu_sd_reader_on_a_synthetic_slice():
    read = core.load_reader("mfu.train.sd")
    ctx = _ctx("osd.train.b640", [("k", 0.0, 10.0)], steps_=60, batch=640)
    least = ops.seconds_at_peak(ops_sd.forward_products(ctx.widths), 3.0)
    assert read(ctx) == pytest.approx(100.0 * 60 * 640 / 1.0 * least)
    assert 0.0 < read(ctx) < 100.0
    assert read(readers.Context(ctx.cell, None, ctx.counts)) is None
    assert read(_ctx("osd.train.b640", [], steps_=0)) is None
