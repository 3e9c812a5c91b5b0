"""The plain reference: the Relation Network of a configuration file in
plain PyTorch, float32, written from the model's description (Santoro et
al. 2017, arXiv:1706.01427, as the port's ``config.json`` sizes it).

It imports nothing of the port and takes nothing the port made: the
harness draws the weights (``draw_weights``) and the data, and hands the
same to both. What it shares with the port is the published function:

* from pixels: a uint8 canvas cropped at its centre (eval) or rotated and
  cropped by the three-shear ``augment`` (train), scaled by 1/255; four
  3x3 stride-2 convolutions, each with BatchNorm (eps 1e-5; batch moments
  with the biased variance in training, running moments in eval) and ReLU;
  the g x g grid of features tagged with its (x, y) coordinates in [-1, 1];
* the question: an embedding (id 0 pads and enters as zeros), an LSTM of
  the configuration's width (gates i, f, g, o; one bias) whose pad steps
  carry the state through, its last state;
* g_theta over all n^2 ordered pairs (object i, object j, question),
  summed; f_phi with ReLU, inverted dropout on its last hidden layer in
  training, and a log-softmax over the answers;
* training: mean NLL, clipping by the global norm (optax's rule: kept below
  the limit, else scaled to it), Adam (b1 0.9, b2 0.999, eps 1e-8) with
  bias correction.

The random draws of a training step are torch's, from a generator on the
device seeded with the train state's seed, in the order the port's step
makes them: the rotation angles, the crop offsets, then the dropout's
uniforms (``step_draws``).

g_theta's layer 0 is computed as u_i + v_j + s (its weight split by rows),
the same function as the concatenated row times the weight; the pairs are
materialised in blocks of samples so that a batch fits, and a training
step recomputes each block in its backward. TF32 is turned off while the
reference runs (``exact_float32``).

``Precision`` gives the precision a comparison is made in and the
controls: the same functions with every operand the port computes in bf16
rounded to bf16 or to fp8 (e4m3 forward, e5m2 gradients, scaled per
tensor); g_theta's layers 1 .. L-1 in int8 as the port's int8 chain runs
them (per-layer scales calibrated on a strided subsample of the batch,
``int8_scales``), or in int4 for its control.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

MAX_DEG = 2.8  # the largest rotation of the augmentation, degrees
BN_EPS = 1e-5
INT8_MARGIN = 1.2  # calibration margin of the int8 chain over its activations' maxima


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    init: str  # "uniform" (bound), "normal", "ones", "zeros"
    bound: float = 0.0
    buffer: bool = False


def g_input_dims(w: Dict) -> List[int]:
    c = w["conv_channels"][-1] + 2
    dims = []
    for l in range(len(w["g_layers"])):
        d = 2 * c if l == 0 else w["g_layers"][l - 1]
        if l == w["question_injection_position"]:
            d += w["lstm_hidden"]
        dims.append(d)
    return dims


def n_objects(w: Dict) -> int:
    g = w["image_size"]
    for _ in w["conv_channels"]:
        g = (g + 2 * (w["conv_kernel"] // 2) - w["conv_kernel"]) // w["conv_stride"] + 1
    return g * g


def layout(w: Dict, vocab: int) -> List[Leaf]:
    """Every parameter and buffer, under the names the port's ``RN`` gives
    them, with PyTorch's default initialisation: U(+-1/sqrt(fan_in)) for
    convolutions and linear layers, U(+-1/sqrt(hidden)) for the LSTM,
    N(0, 1) for the embedding; BatchNorm scale 1, bias 0, moments 0 and 1.
    One departure: f_phi's first kernel is drawn 1/sqrt(n) times narrower
    (n objects; 1/8 at 64), since the sum over the n^2 pairs otherwise
    saturates the answers (14-26 nats of NLL a question, and the same
    answer in any precision, which no comparison could then tell apart);
    so drawn, an untrained model's NLL is 3.6-5 nats."""
    out: List[Leaf] = []
    cin, k = 3, w["conv_kernel"]
    for i, ch in enumerate(w["conv_channels"]):
        b = 1.0 / math.sqrt(cin * k * k)
        out += [Leaf(f"conv.conv{i}.weight", (ch, cin, k, k), "uniform", b), Leaf(f"conv.conv{i}.bias", (ch,), "uniform", b),
                Leaf(f"conv.bn{i}.scale", (ch,), "ones"), Leaf(f"conv.bn{i}.bias", (ch,), "zeros"),
                Leaf(f"conv.bn{i}.mean", (ch,), "zeros", buffer=True), Leaf(f"conv.bn{i}.var", (ch,), "ones", buffer=True)]
        cin = ch
    E, h = w["lstm_word_emb"], w["lstm_hidden"]
    hb = 1.0 / math.sqrt(h)
    out += [Leaf("text.embedding", (vocab, E), "normal"), Leaf("text.wx", (E, 4 * h), "uniform", hb),
            Leaf("text.wh", (h, 4 * h), "uniform", hb), Leaf("text.b", (4 * h,), "uniform", hb)]
    for l, (d, width) in enumerate(zip(g_input_dims(w), w["g_layers"])):
        b = 1.0 / math.sqrt(d)
        out += [Leaf(f"relational.g{l}_kernel", (d, width), "uniform", b),
                Leaf(f"relational.g{l}_bias", (width,), "uniform", b)]
    f = [w["g_layers"][-1], *w["f_layers"], w["n_answers"]]
    for l, (d, width) in enumerate(zip(f[:-1], f[1:])):
        b = 1.0 / math.sqrt(d)
        scale = 1.0 / math.sqrt(n_objects(w)) if l == 0 else 1.0
        out += [Leaf(f"relational.f{l}_kernel", (d, width), "uniform", b * scale),
                Leaf(f"relational.f{l}_bias", (width,), "uniform", b)]
    return out


def draw_weights(w: Dict, vocab: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout``, fp32 on ``device``, from two draws of ``gen``."""
    leaves = layout(w, vocab)
    n_u = sum(math.prod(x.shape) for x in leaves if x.init == "uniform")
    n_n = sum(math.prod(x.shape) for x in leaves if x.init == "normal")
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=gen, device=device)
    out, a_u, a_n = {}, 0, 0
    for x in leaves:
        size = math.prod(x.shape)
        if x.init == "uniform":
            out[x.name] = (uni[a_u:a_u + size] * x.bound).reshape(x.shape)
            a_u += size
        elif x.init == "normal":
            out[x.name] = nor[a_n:a_n + size].reshape(x.shape).clone()
            a_n += size
        else:
            out[x.name] = torch.full(x.shape, 1.0 if x.init == "ones" else 0.0, device=device)
    return out


def parameter_names(w: Dict, vocab: int) -> List[str]:
    return [x.name for x in layout(w, vocab) if not x.buffer]


# ---------------------------------------------------------------------------
# Precision of the controls
# ---------------------------------------------------------------------------

_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    if fmt is None:
        return x
    if fmt == torch.bfloat16:
        return x.to(torch.bfloat16).float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, _FP8_MAX[fmt] / amax, torch.ones_like(amax))
    return (x * scale).to(fmt).float() / scale


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


@dataclasses.dataclass(frozen=True)
class Precision:
    """Where the port computes in bf16, round operands to ``fwd`` (None:
    keep fp32) and the gradients flowing back through them to ``bwd``;
    ``int8``: run g_theta's layers 1 .. L-1 in int8 as the port's int8
    chain does; ``int4``: in int4 where the int8 chain runs in int8."""

    fwd: Optional[torch.dtype] = None
    bwd: Optional[torch.dtype] = None
    int4: bool = False
    int8: bool = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fwd is None:
            return x
        return _Rounded.apply(x, self.fwd, self.bwd)


FLOAT32 = Precision()
BF16 = Precision(torch.bfloat16, torch.bfloat16)
FP8 = Precision(torch.float8_e4m3fn, torch.float8_e5m2)
INT8 = Precision(torch.bfloat16, torch.bfloat16, int8=True)
FP8_INT4 = Precision(torch.float8_e4m3fn, torch.float8_e5m2, int4=True)
PRECISIONS = {"float32": FLOAT32, "bf16": BF16, "int8": INT8, "fp8": FP8, "fp8_int4": FP8_INT4}


# ---------------------------------------------------------------------------
# The augmentation (gather, three-shear rotation about the crop centre, crop)
# ---------------------------------------------------------------------------


def shear_radii(canvas: int, out_size: int) -> Tuple[int, int]:
    reach = max(out_size / 2 + (canvas - out_size), out_size / 2)
    kx = math.ceil(reach * math.tan(math.radians(MAX_DEG / 2)))
    ky = math.ceil(reach * math.sin(math.radians(MAX_DEG)))
    return kx, ky


def _shear(images: torch.Tensor, shifts: torch.Tensor, axis: int, k_max: int) -> torch.Tensor:
    """Displace each line along ``axis`` by its fractional shift: linear
    interpolation as a hat-weighted sum of rolled copies (wrapping)."""
    shape = (images.shape[0], shifts.shape[1], 1, 1) if axis == 2 else (images.shape[0], 1, shifts.shape[1], 1)
    out = torch.zeros_like(images)
    for k in range(-k_max, k_max + 1):
        wgt = torch.clamp(1.0 - (shifts - k).abs(), min=0.0).reshape(shape)
        out = out + wgt * torch.roll(images, k, dims=axis)
    return out


def augment(cache: torch.Tensor, idx: torch.Tensor, angles: torch.Tensor, offs: torch.Tensor,
            out_size: int) -> torch.Tensor:
    """(B, out, out, 3) fp32 in [0, 1]: canvas idx[b] rotated by angles[b]
    about the crop centre (x shear by tan(a/2), y shear by -sin(a), x shear
    again), cropped at offs[b] (row, col)."""
    imgs = cache[idx.long()].float() * (1.0 / 255.0)
    B, S = imgs.shape[:2]
    kx, ky = shear_radii(S, out_size)
    cy = offs[:, 0].float() + (out_size - 1) / 2.0
    cx = offs[:, 1].float() + (out_size - 1) / 2.0
    coord = torch.arange(S, dtype=torch.float32, device=imgs.device)[None, :]
    sx = torch.tan(angles / 2.0)[:, None] * (coord - cy[:, None])
    sy = -torch.sin(angles)[:, None] * (coord - cx[:, None])
    x = _shear(_shear(_shear(imgs, sx, 2, kx), sy, 1, ky), sx, 2, kx)
    starts = offs.long().clamp(0, S - out_size)
    span = torch.arange(out_size, device=imgs.device)
    rows, cols = starts[:, 0, None] + span, starts[:, 1, None] + span
    b = torch.arange(B, device=imgs.device)[:, None, None]
    return x[b, rows[:, :, None], cols[:, None, :]]


def step_draws(gen: torch.Generator, B: int, canvas: int, out_size: int, f_hidden: int, device):
    """(angles, offsets, dropout uniforms) of one training step."""
    angles = (-MAX_DEG + 2.0 * MAX_DEG * torch.rand(B, generator=gen, device=device)) * (math.pi / 180.0)
    offs = torch.randint(0, canvas - out_size + 1, (B, 2), generator=gen, device=device, dtype=torch.int32)
    u = torch.rand((B, f_hidden), generator=gen, device=device)
    return angles, offs, u


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def objects(p: Dict[str, torch.Tensor], w: Dict, images: torch.Tensor, R: Precision, train: bool) -> torch.Tensor:
    """(B, S, S, 3) images in [0, 1] -> (B, g*g, C + 2) tagged objects."""
    x = R(images).permute(0, 3, 1, 2)
    pad = w["conv_kernel"] // 2
    for i in range(len(w["conv_channels"])):
        y = R(F.conv2d(x, R(p[f"conv.conv{i}.weight"]), R(p[f"conv.conv{i}.bias"]), stride=w["conv_stride"],
                       padding=pad))
        if train:
            y = F.batch_norm(y, None, None, p[f"conv.bn{i}.scale"], p[f"conv.bn{i}.bias"], True, 0.0, BN_EPS)
        else:
            y = F.batch_norm(y, p[f"conv.bn{i}.mean"], p[f"conv.bn{i}.var"], p[f"conv.bn{i}.scale"],
                             p[f"conv.bn{i}.bias"], False, 0.0, BN_EPS)
        x = R(torch.relu(y))
    B, C, g, _ = x.shape
    feats = x.permute(0, 2, 3, 1).reshape(B, g * g, C)
    lin = torch.linspace(-1.0, 1.0, g, device=x.device)
    cy, cx = torch.meshgrid(lin, lin, indexing="ij")
    coords = R(torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1))
    return torch.cat([feats, coords[None].expand(B, g * g, 2)], dim=-1)


def eval_images(canvas_u8: torch.Tensor, image_size: int, R: Precision) -> torch.Tensor:
    """Centre crop of a (B, S, S, 3) uint8 canvas, scaled to [0, 1]."""
    p = (canvas_u8.shape[1] - image_size) // 2
    x = canvas_u8[:, p:p + image_size, p:p + image_size, :].float()
    return R(R(x) / 255.0)


def question_state(p: Dict[str, torch.Tensor], w: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T) ids -> (B, hidden): the LSTM's state after the last word."""
    B, T = tokens.shape
    tokens = tokens.long()
    mask = tokens != 0
    x = p["text.embedding"][tokens] * mask[..., None]
    xg = (x.reshape(B * T, -1) @ p["text.wx"] + p["text.b"]).reshape(B, T, -1)
    h = torch.zeros(B, w["lstm_hidden"], device=tokens.device)
    c = torch.zeros_like(h)
    for t in range(T):
        i, f, g, o = (xg[:, t] + h @ p["text.wh"]).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[:, t, None]
        h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
    return h


def _int4(a: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(a / scale * 7.0), 0.0, 7.0)


def _layer0(p: Dict[str, torch.Tensor], w: Dict, x: torch.Tensor, q: torch.Tensor, R: Precision):
    """g_theta's layer 0 split by rows: (u, v, s) of (b, n, c) objects and a
    (b, h) question (question at layer 0)."""
    if w["question_injection_position"] != 0:
        raise ValueError("the reference joins the question at g layer 0 (both configurations do)")
    c = x.shape[-1]
    W0, b0 = R(p["relational.g0_kernel"]), R(p["relational.g0_bias"])
    xr, qr = R(x), R(q)
    return R(xr @ W0[:c]), R(xr @ W0[c:2 * c]), R(b0 + R(qr @ W0[2 * c:]))


def int8_scales(p: Dict[str, torch.Tensor], w: Dict, x: torch.Tensor, q: torch.Tensor, R: Precision) -> torch.Tensor:
    """(L-1,) activation scales of the int8 chain for one batch of (B, n, c)
    objects: the maxima of layers 0 .. L-2 (fp32 math on the rounded
    operands) over a subsample of at most 4 samples and 16 i- and
    j-objects, strided over the batch and both object axes, floored at 1e-6,
    times INT8_MARGIN."""
    B, n, _ = x.shape
    nb, no = min(B, 4), min(n, 16)
    sb, so = -(-B // nb), -(-n // no)
    u, v, s = _layer0(p, w, x[::sb][:nb], q[::sb][:nb], R)
    u, v = u[:, ::so][:, :no], v[:, ::so][:, :no]
    a = torch.relu(u[:, :, None, :] + v[:, None, :, :] + s[:, None, None, :]).reshape(u.shape[0], -1, u.shape[-1])
    acts = [a]
    for l in range(1, len(w["g_layers"]) - 1):
        a = torch.relu(a @ R(p[f"relational.g{l}_kernel"]) + R(p[f"relational.g{l}_bias"]))
        acts.append(a)
    return torch.stack([x.amax() for x in acts]).clamp_min(1e-6) * INT8_MARGIN


def _codes(a: torch.Tensor) -> torch.Tensor:
    """Non-negative activations in their int8 domain to codes 0 .. 127 (round half up)."""
    return torch.floor(torch.clamp(a + 0.5, max=127.0))


def _int8_chain(p: Dict[str, torch.Tensor], w: Dict, u, v, s, scales: torch.Tensor, R: Precision) -> torch.Tensor:
    """Layers 0 .. L-1 of g_theta with int8 codes: layer 0's operands scaled
    into its int8 domain (127 / c_0) and rounded, its codes; each later
    layer's weight to [-127, 127] by its largest magnitude, the products of
    the codes rescaled into the next layer's domain (the last layer's into
    real values) with the bias, ReLU, codes again; the last layer pooled."""
    L = len(w["g_layers"])
    q127 = torch.full_like(scales, 127.0) / scales
    u, v, s = R(u * q127[0]), R(v * q127[0]), R(s * q127[0])
    b = u.shape[0]
    a8 = _codes(torch.relu(u[:, :, None, :] + v[:, None, :, :] + s[:, None, None, :])).reshape(b, -1, u.shape[-1])
    requant = torch.cat([q127[1:], torch.ones(1, dtype=scales.dtype, device=scales.device)])
    for l in range(1, L):
        Wl = R(p[f"relational.g{l}_kernel"])
        sw = Wl.abs().amax().clamp_min(1e-9)
        w8 = torch.clamp(torch.round(Wl / sw * 127.0), -127.0, 127.0)
        m = scales[l - 1] * R(sw / 127.0) / 127.0 * requant[l - 1]
        a = torch.relu((a8 @ w8) * m + R(p[f"relational.g{l}_bias"]) * requant[l - 1])
        if l < L - 1:
            a8 = _codes(a)
    return a.sum(dim=1)


def pooled_g(p: Dict[str, torch.Tensor], w: Dict, x: torch.Tensor, q: torch.Tensor, R: Precision,
             scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, n, c) objects, (b, h) question -> (b, H) g_theta summed over the
    n^2 pairs (question at layer 0); ``scales``: the int8 chain's, from the
    whole batch (``int8_scales``)."""
    L = len(w["g_layers"])
    b, n, _ = x.shape
    u, v, s = _layer0(p, w, x, q, R)
    if R.int8:
        return _int8_chain(p, w, u, v, s, int8_scales(p, w, x, q, R) if scales is None else scales, R)
    a = torch.relu(u[:, :, None, :] + v[:, None, :, :] + s[:, None, None, :]).reshape(b, n * n, -1)
    if R.int4:
        return _int4_chain(p, w, a)
    a = R(a)
    for l in range(1, L):
        a = torch.relu(a @ R(p[f"relational.g{l}_kernel"]) + R(p[f"relational.g{l}_bias"]))
        if l < L - 1:
            a = R(a)
    return a.sum(dim=1)


def _int4_chain(p: Dict[str, torch.Tensor], w: Dict, a: torch.Tensor) -> torch.Tensor:
    """Layers 1 .. L-1 with int4 codes: each layer's input scaled to [0, 7] by
    its maximum times the int8 chain's margin, each weight to [-7, 7] by its
    largest magnitude, the products of the codes rescaled in fp32."""
    L = len(w["g_layers"])
    for l in range(1, L):
        Wl = p[f"relational.g{l}_kernel"]
        sa = a.amax().clamp_min(1e-6) * INT8_MARGIN
        sw = Wl.abs().amax().clamp_min(1e-9)
        wq = torch.clamp(torch.round(Wl / sw * 7.0), -7.0, 7.0)
        a = torch.relu((_int4(a, sa) @ wq) * (sa / 7.0 * sw / 7.0) + p[f"relational.g{l}_bias"])
    return a.sum(dim=1)


def head(p: Dict[str, torch.Tensor], w: Dict, pooled: torch.Tensor, drop_u: Optional[torch.Tensor],
         dropout: float) -> torch.Tensor:
    """f_phi and the log-softmax; inverted dropout of the last hidden layer
    where ``drop_u`` (its uniforms) is given."""
    nf = len(w["f_layers"]) + 1
    y = pooled
    for l in range(nf - 1):
        y = torch.relu(y @ p[f"relational.f{l}_kernel"] + p[f"relational.f{l}_bias"])
    if drop_u is not None:
        keep = 1.0 - dropout
        y = torch.where(drop_u < keep, y / keep, 0.0)
    y = y @ p[f"relational.f{nf - 1}_kernel"] + p[f"relational.f{nf - 1}_bias"]
    return torch.log_softmax(y, dim=-1)


def _blocks(n: int, size: int) -> List[slice]:
    return [slice(a, min(a + size, n)) for a in range(0, n, size)]


@torch.no_grad()
def eval_log_probs(p: Dict[str, torch.Tensor], w: Dict, images: torch.Tensor, tokens: torch.Tensor,
                   R: Precision = FLOAT32, block: int = 64) -> torch.Tensor:
    """(B, n_answers) log-probs in eval mode; ``images`` (B, S, S, 3) uint8
    at the model's size or a larger canvas (centre-cropped)."""
    x = objects(p, w, eval_images(images, w["image_size"], R), R, train=False)
    q = question_state(p, w, tokens)
    scales = int8_scales(p, w, x, q, R) if R.int8 else None
    pooled = torch.cat([pooled_g(p, w, x[s], q[s], R, scales) for s in _blocks(x.shape[0], block)])
    return head(p, w, pooled, None, 0.0)


def loss_and_grads(p: Dict[str, torch.Tensor], w: Dict, images: torch.Tensor, tokens: torch.Tensor,
                   labels: torch.Tensor, drop_u: torch.Tensor, R: Precision = FLOAT32,
                   block: int = 32) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean NLL, gradient of every parameter) of a train-mode forward on
    augmented ``images`` (B, S, S, 3) in [0, 1]. g_theta is run in blocks of
    samples twice: once for the pooled sums, once more in its backward."""
    names = [k for k in p if not (k.endswith(".mean") or k.endswith(".var"))]
    leaves = {k: (p[k].detach().requires_grad_() if k in names else p[k]) for k in p}
    objs = objects(leaves, w, images, R, train=True)
    qv = question_state(leaves, w, tokens)
    xd, qd = objs.detach().requires_grad_(), qv.detach().requires_grad_()
    blocks = _blocks(objs.shape[0], block)
    with torch.no_grad():
        pooled = torch.cat([pooled_g(leaves, w, xd[s], qd[s], R) for s in blocks])
    pd = pooled.requires_grad_()
    logp = head(leaves, w, pd, drop_u, w["dropout"])
    loss = -logp.gather(1, labels.long()[:, None]).mean()
    loss.backward()
    for s in blocks:
        torch.autograd.backward(pooled_g(leaves, w, xd[s], qd[s], R), pd.grad[s])
    torch.autograd.backward([objs, qv], [xd.grad, qd.grad])
    grads = {k: (leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(p[k])) for k in names}
    return loss.detach(), grads


def train_steps(p0: Dict[str, torch.Tensor], w: Dict, cache: torch.Tensor, data: Dict[str, torch.Tensor],
                rows: Sequence[torch.Tensor], gen_seed: int, opt: Dict, R: Precision = FLOAT32,
                half_batch: bool = False, block: int = 32) -> Dict:
    """len(rows) training steps from the weights ``p0`` on the samples
    ``rows[t]``, with the draws of a generator seeded ``gen_seed``: each
    step's loss and gradient norm before the clip, the first step's clipped
    gradient (what Adam gets), and Adam's first moment and the parameters
    after the last step. ``half_batch``: the fault that drops the second
    half of every batch (the mean over the first half)."""
    dev = cache.device
    names = [k for k in p0 if not (k.endswith(".mean") or k.endswith(".var"))]
    params = {k: v.detach().clone().float() for k, v in p0.items()}
    m = {k: torch.zeros_like(params[k]) for k in names}
    v2 = {k: torch.zeros_like(params[k]) for k in names}
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    canvas, size = cache.shape[1], w["image_size"]
    b1, b2, eps, lr, clip = opt["b1"], opt["b2"], opt["eps"], opt["lr"], opt["clip_norm"]
    losses, norms, grad1 = [], [], None
    for t, idx in enumerate(rows, 1):
        B = idx.shape[0]
        angles, offs, u = step_draws(gen, B, canvas, size, w["f_layers"][-1], dev)
        images = augment(cache, data["image_idx"][idx.long()], angles, offs, size)
        tokens, labels = data["question"][idx.long()], data["answer"][idx.long()]
        if half_batch:
            k = B // 2
            images, tokens, labels, u = images[:k], tokens[:k], labels[:k], u[:k]
        loss, g = loss_and_grads(params, w, images, tokens, labels, u, R, block)
        with torch.no_grad():
            norm = torch.sqrt(sum(x.square().sum() for x in g.values()))
            norms.append(float(norm))
            if clip > 0 and norm >= clip:
                g = {k: x / norm * clip for k, x in g.items()}
            for k in names:
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                mhat = m[k] / (1 - b1**t)
                vhat = v2[k] / (1 - b2**t)
                params[k] -= lr * mhat / (vhat.sqrt() + eps)
        losses.append(float(loss))
        if t == 1:
            grad1 = {k: x.detach().clone() for k, x in g.items()}
    return {"loss": losses, "grad_norm": norms, "grad1": grad1, "moment": m, "params": {k: params[k] for k in names}}
