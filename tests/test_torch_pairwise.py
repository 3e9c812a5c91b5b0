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
    if case == "float32":  # fp32 u among bf16 inputs: the kernels take one dtype for all six
        args = _bf16(_inputs(1, 8, 128, 3))
        args[0] = args[0].float()
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


def test_kernel_path_takes_all_fp32_inputs():
    """All six inputs in fp32 pass the kernels' checks (the fp32 kernels of
    csrc/pairwise_f32.cu take them); the CPU tensors are what still raises,
    as do fp16 inputs and storage that is not 16-byte aligned."""
    args = [torch.from_numpy(a) for a in _inputs(2, 8, 128, 3)]
    assert tpw.check_kernel_inputs(*args) == (2, 8, 8, 128, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpw.pairwise_fwd_cuda(*args, inject=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpw.pairwise_bwd_cuda(*args, torch.ones(2, 128), inject=0)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        tpw.check_kernel_inputs(*(a.half() for a in args))
    shifted = list(args)
    shifted[0] = torch.empty(2 * 8 * 128 + 1)[1:].view(2, 8, 128).copy_(args[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpw.check_kernel_inputs(*shifted)


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


def _ring_forward_emulation(args, inject):
    """The fp32 ring forward of csrc/pairwise_f32.cu, emulated in torch on
    the CPU through the data it reads: W^T split and packed by
    ``pack_f32_weights`` and read back by the wgmma descriptor arithmetic
    (K-major core matrices of 8 rows x 16 bytes, LBO 128 B, SBO KD / 4 x 128
    B, column tile ct at 128 KD floats, lo half a stage on), A split into
    tf32 hi / lo, each stage's a_lo.b_hi + a_hi.b_lo + a_hi.b_hi summed from
    zero (in float64, then one fp32 rounding) and added onto the fp32
    running sum, blocks of F32_RING_ROWS["fwd"] rows pooled in fp32 and the
    block partials added in fp64."""
    u, v, s, qa, ws, bs = (torch.from_numpy(a) for a in args)
    B, n, H = u.shape
    L = ws.shape[0] + 1
    kd = tpw.F32_STAGE_BYTES // 8 // H
    stage = tpw.F32_STAGE_BYTES // 4
    chain = tpw.pack_f32_weights(ws.transpose(1, 2)).reshape(-1)
    nn = torch.arange(H)[None, :]
    kk = torch.arange(kd)[:, None]
    idx = (nn // 128) * 128 * kd + (nn % 128) // 8 * (kd // 4 * 32) + (kk // 4) * 32 + (nn % 8) * 4 + kk % 4
    bm = tpw.F32_RING_ROWS["fwd"]
    a = torch.relu(u[:, :, None, :] + v[:, None, :, :] + s[:, None, None, :]).reshape(B, n * n, H)
    for l in range(1, L):
        total = (bs[l - 1] + (qa if l == inject else torch.zeros_like(qa))[:, None, :]).expand(B, n * n, H).clone()
        for q in range(H // kd):
            st = chain[((l - 1) * (H // kd) + q) * stage:][:stage]
            bh, bl = st[idx].double(), st[stage // 2 + idx].double()
            x = a[..., q * kd:(q + 1) * kd]
            ah = tpw.tf32_round(x)
            al = ((x - ah).view(torch.int32) & -0x2000).view(torch.float32)  # the tf32 bits the tensor cores read
            part = al.double() @ bh + ah.double() @ bl + ah.double() @ bh
            total = total + part.float()
        a = torch.relu(total)
    blocks = a.reshape(B, -1, bm, H) if (n * n) % bm == 0 else None
    assert blocks is not None
    return blocks.sum(dim=2).double().sum(dim=1).float().numpy()


@pytest.mark.parametrize("L, inject", [(3, 0), (4, 2), (4, 0), (3, 1)])
def test_ring_kernel_arithmetic_matches_jax_fp32(L, inject):
    """The fp32 ring kernels' 3xTF32 arithmetic on the packed W stages (an
    emulation of what csrc/pairwise_f32.cu reads and adds) vs rnet's fp32
    jnp reference: within 1e-5 of max |ref|, the error of fp32 sums in
    another order (single-pass TF32 would be ~1e-3 off)."""
    H = tpw.F32_RING_WIDTH
    args = _inputs(2, 16, H, L, seed=H + L + inject)
    want = np.asarray(jpw.pairwise_core_reference(*[jnp.asarray(a) for a in args], inject))
    got = _ring_forward_emulation(args, inject)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _jax_vjp(args, g, inject, dtype):
    core = lambda *a: jpw.pairwise_core(*a, inject=inject, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(core, *[jnp.asarray(a, dtype) for a in args])
    return [np.asarray(d, np.float32) for d in vjp(jnp.asarray(g))]


GRAD_NAMES = ["du", "dv", "ds", "dqa", "dws", "dbs"]


def _streamed(ws, plan, transpose):
    """What each CTA of the plan's cluster reads of x = W^T (``transpose``)
    or W of ws (L-1, N, K) from its W stream: ``pack_weight_chunks`` of its
    ``pair_halves`` slice (``_pack_for``), read back at the chunk and
    core-matrix offsets the kernel's descriptors use (chunk q = n_tile * (K
    / kc) + k_chunk of nt x kc, core matrices of 8 x 8). Returns (cluster,
    L-1, N / cluster, K): rank c's row n, at depth k of its stream (its own
    K share first)."""
    n_l, N, K = ws.shape
    width = N // plan.cluster
    packed = tpw._pack_for(ws, plan, transpose).reshape(plan.cluster, n_l, -1)
    nt, kc = tpw.TILE_N, tpw.CHUNK_BYTES // 2 // tpw.TILE_N
    nn, kk = torch.arange(width)[:, None], torch.arange(K)[None, :]
    chunk = (nn // nt) * (K // kc) + kk // kc
    idx = chunk * nt * kc + ((nn % nt) // 8 * (kc // 8) + (kk % kc) // 8) * 64 + (nn % 8) * 8 + kk % 8
    return packed[:, :, idx]


def _core_index(rows, width):
    """core_off (csrc/pairwise_chain.cuh) of every (row, column) of a
    rows x width core-matrix tile, as a (rows, width) index tensor."""
    r = torch.arange(rows).view(-1, 1)
    c = torch.arange(width).view(1, -1)
    return ((((r >> 3) * (width >> 3) + (c >> 3)) << 6) + ((r & 7) << 3) + (c & 7))


def _stored_tiles_dw(stored, plan, L, splits, part=None):
    """dw_gemm_kernel over the tiles one launch of the bf16 backward stored
    under `plan` (one sample group): `stored` is the flat act buffer (2, L-1,
    the group's B x nblk blocks, cluster ranks, bm x W tiles in core-matrix
    order); CTA (split, tile) gathers its 64-row chunks with the kernel's
    offsets (A: 128 columns of a_{l-1}, D: ``dw_tile``'s columns of dpre_l,
    one copy per 8-row group each), multiplies, sums its chunks from zero
    and adds the sum onto `part`, the splits' partials of the groups before
    (zero when None). Returns part."""
    H, W, cl, bm = plan.H, plan.width, plan.cluster, plan.bm
    gm, gn = tpw.dw_tile(H)
    tile_el = bm * W
    nb = plan.B * plan.nblk
    per_layer = (H // gm) * (H // gn)
    ntiles = (L - 1) * per_layer
    cpb = bm // 64
    nq = cpb * nb
    a_idx, d_idx = _core_index(64, gm), _core_index(64, gn)
    part = torch.zeros((splits, L - 1, H, H)) if part is None else part
    for cta in range(splits * ntiles):
        sp, t = divmod(cta, ntiles)
        li, m0, n0 = t // per_layer, (t % per_layer) // (H // gn) * gm, t % (H // gn) * gn
        a_base = (li * nb * cl + m0 // W) * tile_el + (m0 % W) // 8 * 64
        d_base = ((L - 1 + li) * nb * cl + n0 // W) * tile_el + (n0 % W) // 8 * 64
        acc = torch.zeros(gm, gn)
        for q in range(nq * sp // splits, nq * (sp + 1) // splits):
            off = (q // cpb) * cl * tile_el + (q % cpb) * 64 * W  # block, then chunk
            a_stage = torch.cat([stored[a_base + off + rg * 8 * W:][:gm // 8 * 64] for rg in range(8)])
            d_stage = torch.cat([stored[d_base + off + rg * 8 * W:][:gn // 8 * 64] for rg in range(8)])
            acc += a_stage[a_idx].T @ d_stage[d_idx]
        part[sp, li, m0:m0 + gm, n0:n0 + gn] += acc
    return part


def _in_order(parts):
    """parts[0] + parts[1] + ..., in order, as reduce_partials_kernel adds them."""
    total = torch.zeros_like(parts[0])
    for p in parts:
        total += p
    return total


def _pair_backward_emulation(args, g, inject, sms, esize=4):
    """The column-split backward of the cluster kernels (H = 512), emulated
    in fp32 torch on the CPU through what each CTA holds and reads: rank c
    keeps the activation columns c W .. (W = H / 2) of every block; every
    product is its own share of the depth (its tile) times the first W of its
    streamed W rows, plus the peer's share (read through distributed shared
    memory) times the last W. du, dv, ds, dqa and db of each column come
    from its owner CTA alone. dW, with ``esize=4`` (the fp32 kernel): CTA
    (pair q, rank c)'s partial is the H x W block a_{l-1}^T dpre_l[:, own
    columns] summed over the pair's blocks, and the partials are added over
    the pairs in pair order into dW's columns of rank c. With ``esize=2``
    (the bf16 kernel's plan and route): each CTA stores a_{l-1} and dpre_l
    of its columns per block as 128-row core-matrix tiles (rows past the
    block's end: a garbage, dpre 0, as the kernel leaves them), and
    _stored_tiles_dw sums them as dw_gemm_kernel does."""
    u, v, s, qa, ws, bs = (torch.from_numpy(a) for a in args)
    g = torch.from_numpy(g)
    B, n, H = u.shape
    L = ws.shape[0] + 1
    plan = tpw.tile_plan("bwd", B, n, n, H, L, sms, esize=esize)
    assert plan.cluster == 2 and plan.grid > 2  # several pairs: their partials are added in order
    W = plan.width
    chain, dstream = _streamed(ws, plan, True), _streamed(ws, plan, False)
    cols = [plan.columns(c) for c in range(2)]
    part = torch.zeros((plan.grid, L - 1, H, W))
    tile_el = plan.bm * W
    stored = torch.zeros(2 * (L - 1) * B * plan.nblk * 2 * tile_el)
    t_idx = _core_index(plan.bm, W).flatten()
    du, dv, ds, dqa = torch.zeros(B, n, H), torch.zeros(B, n, H), torch.zeros(B, H), torch.zeros(B, H)
    dbs = torch.zeros(L - 1, H)

    def split(x, stream):  # every rank's product: own share x stream[:W] + the peer's x stream[W:]
        return [x[c] @ stream[c][:, :W].T + x[1 - c] @ stream[c][:, W:].T for c in range(2)]

    for q in range(0, plan.grid, 2):
        assert plan.blocks(q) == plan.blocks(q + 1)  # both CTAs walk the same rows
        for b, p0, rows in plan.blocks(q):
            p = torch.arange(p0, p0 + rows)
            i, j = p // n, p % n
            a0 = torch.relu(u[b, i] + v[b, j] + s[b])
            acts = [[a0[:, cols[c]] for c in range(2)]]
            for l in range(1, L):
                pre = split(acts[-1], chain[:, l - 1])
                extra = [bs[l - 1, cols[c]] + (qa[b, cols[c]] if l == inject else 0.0) for c in range(2)]
                acts.append([torch.relu(pre[c] + extra[c]) for c in range(2)])
            dpre = [torch.where(acts[L - 1][c] > 0, g[b, cols[c]].expand(rows, W), 0.0) for c in range(2)]
            for l in range(L - 1, 0, -1):
                a_full = torch.cat(acts[l - 1], dim=1)  # rank 0's columns, then rank 1's
                for c in range(2):
                    if esize == 4:
                        part[q + c, l - 1] += a_full.T @ dpre[c]
                    else:  # the two tiles of rank c in the act buffer's [which][l-1][block][rank] order
                        gblk = b * plan.nblk + p0 // plan.bm
                        for which, x, pad in ((0, acts[l - 1][c], 1.0), (1, dpre[c], 0.0)):
                            tile = torch.full((plan.bm, W), pad)
                            tile[:rows] = x
                            at = (((which * (L - 1) + l - 1) * B * plan.nblk + gblk) * 2 + c) * tile_el
                            stored[at:at + tile_el][t_idx] = tile.flatten()
                    dbs[l - 1, cols[c]] += dpre[c].sum(0)
                    if l == inject:
                        dqa[b, cols[c]] += dpre[c].sum(0)
                d = split(dpre, dstream[:, l - 1])
                dpre = [torch.where(acts[l - 1][c] > 0, d[c], 0.0) for c in range(2)]
            for c in range(2):
                du[b, :, cols[c]] += torch.zeros(n, W).index_add_(0, i, dpre[c])
                dv[b, :, cols[c]] += torch.zeros(n, W).index_add_(0, j, dpre[c])
                ds[b, cols[c]] += dpre[c].sum(0)
    dws = torch.zeros(L - 1, H, H)
    if esize == 2:
        dws = _in_order(_stored_tiles_dw(stored, plan, L, tpw.dw_splits(plan, 64)))
    for c in range(2 if esize == 4 else 0):
        for q in range(0, plan.grid, 2):  # pair order
            dws[:, :, cols[c]] += part[q + c]
    return [t.numpy() for t in (du, dv, ds, dqa, dws, dbs)]


@pytest.mark.parametrize("inject", [1, 2])
def test_pair_backward_column_split_matches_jax_vjp_fp32(inject):
    """The cluster backward's column split at a shrunk H=512 shape (B=2, n=4,
    L=3, two pairs of CTAs, one sample each): N-half packing of W^T and W,
    the depth split into the CTA's own share and its peer's, per-half dW
    partials added in pair order, vs the VJP of rnet's Pallas kernel in
    interpret mode, in fp32, at tests/test_kernel.py's VJP tolerance (rtol
    5e-4, atol 5e-3: the sums in another order)."""
    H = tpw.PAIR_WIDTH
    args = _inputs(2, 4, H, 3, seed=90 + inject)
    g = _upstream(2, H, 95 + inject)
    want = _jax_vjp(args, g, inject, jnp.float32)
    got = _pair_backward_emulation(args, g, inject, sms=4)
    for name, w, d in zip(GRAD_NAMES, want, got):
        assert d.shape == w.shape, name
        np.testing.assert_allclose(d, w, rtol=5e-4, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("inject", [1, 2])
def test_pair_backward_stored_tiles_match_jax_vjp_fp32(inject):
    """The bf16 cluster backward's route to dW at a shrunk H=512 shape (B=2,
    n=4, L=3: one 128-row block a sample, 16 rows valid), emulated in fp32:
    each rank stores a_{l-1} and dpre_l of its columns as core-matrix tiles,
    and dw_gemm_kernel's tiles, chunk offsets and splits (4, added in order)
    sum a_{l-1}^T dpre_l over them; vs the VJP of rnet's Pallas kernel in
    interpret mode, at tests/test_kernel.py's VJP tolerance (rtol 5e-4,
    atol 5e-3: the sums in another order)."""
    H = tpw.PAIR_WIDTH
    args = _inputs(2, 4, H, 3, seed=80 + inject)
    g = _upstream(2, H, 85 + inject)
    want = _jax_vjp(args, g, inject, jnp.float32)
    got = _pair_backward_emulation(args, g, inject, sms=4, esize=2)
    for name, w, d in zip(GRAD_NAMES, want, got):
        assert d.shape == w.shape, name
        np.testing.assert_allclose(d, w, rtol=5e-4, atol=5e-3, err_msg=name)


def _one_cta_backward_emulation(args, g, inject, sms, keep=1.0, seed=None):
    """The one-CTA bf16 backward (H <= 384) as csrc/pairwise_bwd.cu
    decomposes it, emulated in fp32 torch on the CPU: the batch in
    ``bwd_groups`` (BWD_STORE_BUDGET), each group under its own plan. Every
    CTA walks its blocks (``blocks``), recomputes their rows, scales the
    upstream gradient by the pair mask of the sample's place in the whole
    batch, and per layer stores a_{l-1} and dpre_l as bm-row core-matrix
    tiles at the kernel's offsets of the group's act buffer (rows past the
    block's end: a garbage, dpre 0, as the kernel leaves them), adds db into
    its CTA's partial and dqa, du, dv and ds into its split's slice (the
    slices added in split order after each group). dW: _stored_tiles_dw over
    each group's tiles onto the splits' partials of the groups before, the
    splits then added in order; db: the CTAs' partials in CTA order."""
    u, v, s, qa, ws, bs = (torch.from_numpy(a) for a in args)
    g = torch.from_numpy(g)
    B, n, H = u.shape
    L = ws.shape[0] + 1
    groups = tpw.bwd_groups(B, n, n, H, L, sms)
    first = groups[0][1]
    assert first.cluster == 1
    scale = tpw._pair_scale(seed, B, n, n, keep) if keep < 1.0 else torch.ones(B, n * n)
    du, dv, ds, dqa = torch.zeros(B, n, H), torch.zeros(B, n, H), torch.zeros(B, H), torch.zeros(B, H)
    db_part = torch.zeros(max(plan.grid for _, plan in groups), L - 1, H)
    gemm_splits, part = tpw.dw_splits(first, sms), None
    for b0, plan in groups:
        G, S, bm, tile_el = plan.B, plan.splits, plan.bm, plan.bm * H
        stored = torch.zeros(2 * (L - 1) * G * plan.nblk * tile_el)
        t_idx = _core_index(bm, H).flatten()
        sdu, sdv = torch.zeros(S, G, n, H), torch.zeros(S, G, n, H)  # the splits' slices
        sds, sdqa = torch.zeros(S, G, H), torch.zeros(S, G, H)
        for cta in range(plan.grid):
            k = cta % S  # one unit a CTA when S > 1: split k of its sample
            for bl, p0, rows in plan.blocks(cta):
                b = b0 + bl
                p = torch.arange(p0, p0 + rows)
                i, j = p // n, p % n
                acts = [torch.relu(u[b, i] + v[b, j] + s[b])]
                for l in range(1, L):
                    acts.append(torch.relu(acts[-1] @ ws[l - 1] + bs[l - 1] + (qa[b] if l == inject else 0.0)))
                dpre = torch.where(acts[L - 1] > 0, g[b] * scale[b, p][:, None], 0.0)
                for l in range(L - 1, 0, -1):
                    blk = bl * plan.nblk + p0 // bm
                    for which, x, pad in ((0, acts[l - 1], 1.0), (1, dpre, 0.0)):
                        tile = torch.full((bm, H), pad)
                        tile[:rows] = x
                        at = ((which * (L - 1) + l - 1) * G * plan.nblk + blk) * tile_el
                        stored[at:at + tile_el][t_idx] = tile.flatten()
                    db_part[cta, l - 1] += dpre.sum(0)
                    if l == inject:
                        sdqa[k, bl] += dpre.sum(0)
                    dpre = torch.where(acts[l - 1] > 0, dpre @ ws[l - 1].T, 0.0)
                sdu[k, bl] += torch.zeros(n, H).index_add_(0, i, dpre)
                sdv[k, bl] += torch.zeros(n, H).index_add_(0, j, dpre)
                sds[k, bl] += dpre.sum(0)
        for full, sl in ((du, sdu), (dv, sdv), (ds, sds), (dqa, sdqa)):
            full[b0:b0 + G] = _in_order(sl)
        part = _stored_tiles_dw(stored, plan, L, gemm_splits, part)
    return [t.numpy() for t in (du, dv, ds, dqa, _in_order(part), _in_order(db_part))]


def _jax_vjp_per_pair(args, g, inject, scale):
    """The VJP of the pooled core under an explicit per-pair scale (B, ni*nj)
    (the pair mask over keep), in fp32: rnet's jnp reference on every pair as
    a sample of one pair, its upstream gradient g[b] times the pair's scale,
    the per-pair gradients gathered back (du over j, dv over i, ds and dqa
    over the pairs)."""
    u, v, s, qa, ws, bs = args
    B, n, H = u.shape
    bb, ii, jj = (x.ravel() for x in np.meshgrid(np.arange(B), np.arange(n), np.arange(n), indexing="ij"))
    core = lambda *a: jpw.pairwise_core_reference(*a, inject)  # noqa: E731
    _, vjp = jax.vjp(core, *[jnp.asarray(a) for a in (u[bb, ii][:, None], v[bb, jj][:, None], s[bb], qa[bb], ws, bs)])
    pg = jnp.asarray(g[bb] * np.asarray(scale, np.float32).reshape(-1)[:, None])
    du1, dv1, ds1, dqa1, dws, dbs = (np.asarray(d, np.float32) for d in vjp(pg))
    du, dv, ds, dqa = np.zeros((B, n, H)), np.zeros((B, n, H)), np.zeros((B, H)), np.zeros((B, H))
    np.add.at(du, (bb, ii), du1[:, 0])
    np.add.at(dv, (bb, jj), dv1[:, 0])
    np.add.at(ds, bb, ds1)
    np.add.at(dqa, bb, dqa1)
    return [x.astype(np.float32) for x in (du, dv, ds, dqa, dws, dbs)]


# (H, sms, warpgroups, CTAs a sample): original-fp's width (128-row blocks,
# dW tiles of 128 x 256) on a card of 8 SMs and H=384 (64-row blocks, tiles
# of 128 x 128) on 32, each with 2 GEMM splits
ONE_CTA_ROUTES = [(256, 8, 2, 2), (384, 32, 1, 3)]


@pytest.mark.parametrize("keep", [1.0, 0.75])
@pytest.mark.parametrize("inject", [1, 2])
@pytest.mark.parametrize("H, sms, wgs, splits", ONE_CTA_ROUTES, ids=["H256-wgs2", "H384-wgs1"])
def test_one_cta_backward_stored_tiles_match_jax_vjp_fp32(H, sms, wgs, splits, inject, keep):
    """The one-CTA bf16 backward's route to dW (B=3, n=12: 144 pair rows a
    sample, the last block ragged, L=4), emulated in fp32: each CTA stores
    a_{l-1} and dpre_l of its blocks as core-matrix tiles, and
    dw_gemm_kernel's tiles, chunk offsets and splits sum a_{l-1}^T dpre_l over
    them; db from the CTAs' partials, du, dv, ds, dqa from the sample
    splits' slices. Against JAX's VJP at tests/test_kernel.py's VJP
    tolerance (rtol 5e-4, atol 5e-3: the sums in another order): rnet's
    Pallas kernel in interpret mode at keep 1; at keep 0.75, rnet's jnp
    reference under the explicit Philox mask (``_jax_vjp_per_pair``)."""
    args = _inputs(3, 12, H, 4, seed=H + 10 * inject + int(4 * keep))
    g = _upstream(3, H, H + 11 * inject)
    plan = tpw.tile_plan("bwd", 3, 12, 12, H, 4, sms)
    assert (plan.wgs, plan.splits, len(tpw.bwd_groups(3, 12, 12, H, 4, sms))) == (wgs, splits, 1)
    assert tpw.dw_splits(plan, sms) == 2 and plan.nblk * plan.bm > 144
    seed = _seed(4242 + H) if keep < 1 else None
    got = _one_cta_backward_emulation(args, g, inject, sms, keep, seed)
    if keep == 1.0:
        want = _jax_vjp(args, g, inject, jnp.float32)
    else:
        scale = tpw._pair_scale(seed, 3, 12, 12, keep).numpy()
        assert 0 < (scale == 0).mean() < 0.5
        want = _jax_vjp_per_pair(args, g, inject, scale)
    for name, w, d in zip(GRAD_NAMES, want, got):
        assert d.shape == w.shape, name
        np.testing.assert_allclose(d, w, rtol=5e-4, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("H, sms, keep", [(256, 8, 0.75), (384, 32, 1.0)], ids=["H256-keep0.75", "H384-keep1"])
def test_one_cta_backward_in_sample_groups_matches_jax_vjp_fp32(monkeypatch, H, sms, keep):
    """The same route with BWD_STORE_BUDGET shrunk to two samples' tiles:
    B=3 runs as groups of 2 and 1 samples, each with its own plan (sample
    splits, grid), the GEMM of the second adding onto the first's split
    partials, db onto the same CTA partials, the pair mask drawn at each
    sample's place in the batch; against JAX's VJP as above."""
    stored = tpw.stored_bytes(tpw.tile_plan("bwd", 1, 12, 12, H, 4, sms))
    monkeypatch.setattr(tpw, "BWD_STORE_BUDGET", 2 * stored)
    groups = tpw.bwd_groups(3, 12, 12, H, 4, sms)
    assert [(b0, plan.B) for b0, plan in groups] == [(0, 2), (2, 1)]
    args = _inputs(3, 12, H, 4, seed=H + 7)
    g = _upstream(3, H, H + 8)
    seed = _seed(99 + H) if keep < 1 else None
    got = _one_cta_backward_emulation(args, g, 2, sms, keep, seed)
    if keep == 1.0:
        want = _jax_vjp(args, g, 2, jnp.float32)
    else:
        want = _jax_vjp_per_pair(args, g, 2, tpw._pair_scale(seed, 3, 12, 12, keep).numpy())
    for name, w, d in zip(GRAD_NAMES, want, got):
        np.testing.assert_allclose(d, w, rtol=5e-4, atol=5e-3, err_msg=name)


def _f32_streamed(ws, plan, transpose):
    """What each CTA of the plan's cluster reads of x = W^T (``transpose``)
    or W of ws (L-1, N, K) from its fp32 W stream: ``pack_f32_weights`` of
    its ``pair_halves`` slice (``_pack_f32_for``), read back at the offsets
    the ring kernels' descriptors use (stage k // KD, column tile n // 128
    at 128 KD floats, core matrices of 8 rows x 4 fp32 of depth, lo half a
    stage after hi). Returns (hi, lo), each (cluster, L-1, N / cluster, K):
    rank c's row n at depth k of its stream (its own K share first)."""
    n_l, N, K = ws.shape
    width = N // plan.cluster
    kd = tpw.F32_STAGE_BYTES // 8 // width
    stage = tpw.F32_STAGE_BYTES // 4
    packed = tpw._pack_f32_for(ws, plan, transpose).reshape(plan.cluster, n_l, -1)
    nn, kk = torch.arange(width)[:, None], torch.arange(K)[None, :]
    idx = ((kk // kd) * stage + (nn // 128) * 128 * kd + (nn % 128) // 8 * 8 * kd + (kk % kd) // 4 * 32
           + (nn % 8) * 4 + kk % 4)
    return packed[:, :, idx], packed[:, :, idx + stage // 2]


def _pair_forward_emulation(args, inject, sms, esize):
    """The column-split forward of the cluster kernels (H = 512), emulated
    in fp32 torch on the CPU through what each CTA holds and reads: both CTAs
    of a cluster walk the same blocks; rank c keeps the activation columns c
    W .. (W = H / 2) of its block and computes those output columns, its
    own share of the depth (its tile) against the first W of its streamed
    W rows, the peer's share (read through distributed shared memory)
    against the last W. ``esize=4``: the fp32 kernel's 3xTF32 on the
    packed hi / lo stages, each stage summed from zero (in float64, then one
    fp32 rounding) and added onto the fp32 running sum, each block's column
    sums in fp32, the blocks added in fp64. ``esize=2``: the bf16 kernel's
    plan and W chunks, in fp32 (no bf16 rounding), each block pooled into
    its partial row (two warpgroups, each on 128 of a rank's columns), the
    partials added in order."""
    u, v, s, qa, ws, bs = (torch.from_numpy(a) for a in args)
    B, n, H = u.shape
    L = ws.shape[0] + 1
    plan = tpw.tile_plan("fwd", B, n, n, H, L, sms, esize=esize)
    assert plan.cluster == 2 and plan.width == H // 2
    W = plan.width
    cols = [plan.columns(c) for c in range(2)]
    if esize == 4:
        hi, lo = _f32_streamed(ws, plan, True)
        kd = tpw.F32_STAGE_BYTES // 8 // W
    else:
        chain = _streamed(ws, plan, True)
    partial = torch.zeros(B, plan.nblk, H)

    def product(c, x, l):  # rank c's output columns of a . W_l over the depth as it streams: own share first
        if esize == 2:
            return x @ chain[c, l - 1].T
        total = torch.zeros(x.shape[0], W)
        for k0 in range(0, H, kd):
            xs = x[:, k0:k0 + kd]
            ah = tpw.tf32_round(xs)
            al = ((xs - ah).view(torch.int32) & -0x2000).view(torch.float32)  # the tf32 bits the tensor cores read
            bh, bl = hi[c, l - 1][:, k0:k0 + kd].double().T, lo[c, l - 1][:, k0:k0 + kd].double().T
            total = total + (al.double() @ bh + ah.double() @ bl + ah.double() @ bh).float()
        return total

    for q in range(0, plan.grid, 2):
        assert plan.blocks(q) == plan.blocks(q + 1)  # both CTAs walk the same rows
        for b, p0, rows in plan.blocks(q):
            p = torch.arange(p0, p0 + rows)
            a0 = torch.relu(u[b, p // n] + v[b, p % n] + s[b])
            acts = [a0[:, cols[c]] for c in range(2)]
            for l in range(1, L):
                acts = [torch.relu(product(c, torch.cat([acts[c], acts[1 - c]], dim=1), l) + bs[l - 1, cols[c]]
                                   + (qa[b, cols[c]] if l == inject else 0.0)) for c in range(2)]
            for c in range(2):
                partial[b, p0 // plan.bm, cols[c]] = acts[c].sum(0)
    if esize == 4:
        return partial.double().sum(dim=1).float().numpy()
    out = torch.zeros(B, H)
    for k in range(partial.shape[1]):  # in part order, as pool_partials_kernel
        out += partial[:, k]
    return out.numpy()


@pytest.mark.parametrize("inject", [1, 2])
def test_pair_forward_column_split_matches_jax_fp32(inject):
    """The fp32 cluster forward's column split at a shrunk H=512 shape (B=2,
    n=4, L=3: two clusters, a 128-row block each, 16 rows valid): each rank
    streams pack_f32_weights of its pair_halves slice of W^T, its own share
    of the depth first, in 3xTF32 on the packed stages, vs rnet's Pallas
    kernel in interpret mode in fp32: within 1e-5 of max |ref|, as the
    one-CTA ring kernel's arithmetic (test_ring_kernel_arithmetic_matches_jax_fp32)."""
    H = tpw.PAIR_WIDTH
    args = _inputs(2, 4, H, 3, seed=70 + inject)
    want = np.asarray(jpw.pairwise_core(*[jnp.asarray(a) for a in args], inject=inject, interpret=True))
    got = _pair_forward_emulation(args, inject, sms=4, esize=4)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("sms", [4, 8], ids=["rows128", "rows64"])
@pytest.mark.parametrize("inject", [1, 2])
def test_pair_forward_column_split_matches_jax_bf16_route(inject, sms):
    """The bf16 cluster forward's column split at a shrunk H=512 shape (B=2,
    n=4, L=3), emulated in fp32: each rank reads pack_weight_chunks of its
    pair_halves slice of W^T, its own share of the depth first, and pools
    each block into its partial row; with 4 SMs the plan's 128-row blocks,
    with 8 (too few tiles for 4 clusters) 64-row blocks. Against rnet's Pallas kernel in interpret
    mode at tests/test_kernel.py's forward tolerance (rtol 2e-4, atol
    5e-3)."""
    H = tpw.PAIR_WIDTH
    args = _inputs(2, 4, H, 3, seed=60 + inject)
    plan = tpw.tile_plan("fwd", 2, 4, 4, H, 3, sms)
    assert (plan.wgs, plan.bm) == ((2, 128) if sms == 4 else (2, 64))
    want = np.asarray(jpw.pairwise_core(*[jnp.asarray(a) for a in args], inject=inject, interpret=True))
    got = _pair_forward_emulation(args, inject, sms=sms, esize=2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-3)


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


@pytest.mark.parametrize("keep", [1.0, 0.75])
@pytest.mark.parametrize("esize, H", [(2, 128), (4, 256)], ids=["bf16-plan", "fp32-ring-plan"])
def test_split_bwd_reference_matches_the_whole_and_jax_vjp(esize, H, keep):
    """The backward's sample splits (B < SMs): B=3, n=24 (576 pair rows) on a
    card of 16 SMs (``sms=16``: 5 splits a sample; the bf16 plan's 128-row
    blocks, the last ragged, one a split; the fp32 ring plan's 64-row blocks,
    9 over 5 splits). ``split_bwd_reference`` runs each split's rows alone
    and adds the splits in split order; in fp32 it equals the plain backward
    of the whole up to the order of the sums (max |split - whole| <= 2e-6
    max |whole| per gradient: fp32 sums of up to 1,728 rows regrouped, ~4e-7
    seen), pair dropout included, and (keep 1) the VJP of
    rnet's Pallas kernel in interpret mode at tests/test_kernel.py's VJP
    tolerance (rtol 5e-4, atol 5e-3). With one split it is the plain
    backward, bit for bit."""
    args = _inputs(3, 24, H, 3, seed=110 + H)
    g = _upstream(3, H, 111 + H)
    seed = _seed(777) if keep < 1 else None
    plan = tpw.tile_plan("bwd", 3, 24, 24, H, 3, 16, esize=esize)
    assert plan.splits == 5 and plan.grid == 15 and plan.nblk == (5 if esize == 2 else 9)
    assert plan.bm * plan.nblk > 24 * 24 or esize == 4  # bf16: a ragged last block
    whole = tpw.pairwise_core_bwd_reference(*_t(args), torch.from_numpy(g), 1, keep, seed)
    split = tpw.split_bwd_reference(plan, *_t(args), torch.from_numpy(g), 1, keep, seed)
    for name, w, d in zip(GRAD_NAMES, whole, split):
        assert d.dtype == torch.float32 and d.shape == w.shape, name
        assert (d - w).abs().max() <= 2e-6 * w.abs().max(), name
    one = tpw.tile_plan("bwd", 3, 24, 24, H, 3, 3, esize=esize)
    assert one.splits == 1
    one_split = tpw.split_bwd_reference(one, *_t(args), torch.from_numpy(g), 1, keep, seed)
    assert all(torch.equal(a, b) for a, b in zip(one_split, whole))
    if keep == 1.0:
        want = _jax_vjp(args, g, 1, jnp.float32)
        for name, w, d in zip(GRAD_NAMES, want, split):
            np.testing.assert_allclose(d.numpy(), w, rtol=5e-4, atol=5e-3, err_msg=name)


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
    assert len(tpw.F32_BWD_PHASES) == len(tpw.BWD_PHASES)
