"""The plain reference of the state-description Relation Network: plain
PyTorch, float32, written from the model's description (Santoro et al.
2017, arXiv:1706.01427, section 5.1 and its appendix on CLEVR from state
descriptions, as the repository's ``config.json`` entry ``original-sd``
sizes it).

It imports nothing of the port and takes nothing the port made: the
harness draws the weights (``draw_weights``) and the data, and hands the
same to both. The function:

* objects: a scene's objects as 18 numbers each (the 3-D position over 3,
  one-hots of colour 8, shape 3, material 2 and size 2), zero-padded to
  12; the pads take part in the pairs as they come, with no mask, as the
  published model and ``config.json`` (``object_mask`` false) do;
* the question: ``reference.question_state``, an embedding (id 0 pads and
  enters as zeros) and an LSTM of width 256 whose pad steps carry the state
  through (``lstm_mask_pads``, as the configuration states), its last state;
* g_theta, 4 x 512, over all 144 ordered pairs (object i, object j,
  question) and summed (``pooled_g``: layer 0 as u_i + v_j + s, the same
  function as the concatenated row times the weight); f_phi
  512 -> 1024 -> 28 with ReLU, inverted dropout on its last hidden layer
  in training, and a log-softmax (``reference.head``);
* training: mean NLL, clipping by the global norm (optax's rule), Adam (b1
  0.9, b2 0.999, eps 1e-8) with bias correction.

Departures from the paper, each as the port's ``config.json`` has it:

* dropout 0.05 on f_phi's last hidden layer, where the paper says 2 %;
* 28 answers, CLEVR's answer set, where the paper's output layer has 29
  units;
* the effective batch of 640 runs as one batch on one card, where the
  paper took 10 synchronous workers of 64 questions each; the gradient of
  the mean over 640 is the mean of the ten workers' gradients.

The random draws of a training step are torch's, from a generator on the
device seeded with the train state's seed, in the order the port's step
makes them: a state-description step draws only f_phi's dropout uniforms,
(B, 1024) (``step_draws``). TF32 is off while the reference runs
(``reference.exact_float32``); ``reference.Precision`` gives the
precision a comparison is made in and the controls: g_theta is the only
part the port computes in bf16, and ``pooled_g`` rounds where the port's
bf16 route rounds, so that in bf16 the two differ by the order of their
sums alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from .reference import FLOAT32, Leaf, Precision, _blocks, head, question_state


def g_input_dims(w: Dict) -> List[int]:
    """Input width of each g layer: the pair of objects, the question at its layer."""
    dims = []
    for l in range(len(w["g_layers"])):
        d = 2 * w["object_dim"] if l == 0 else w["g_layers"][l - 1]
        if l == w["question_injection_position"]:
            d += w["lstm_hidden"]
        dims.append(d)
    return dims


def layout(w: Dict, vocab: int) -> List[Leaf]:
    """Every parameter, under the names the port's ``RN`` gives them, with
    PyTorch's default initialisation: U(+-1/sqrt(hidden)) for the LSTM,
    N(0, 1) for the embedding, U(+-1/sqrt(fan_in)) for the linear layers.
    Unlike ``reference.layout``, f_phi's first kernel is not drawn narrower:
    over 144 pairs of 18-number objects the pooled sums stay small (a mean
    magnitude of ~1.7), and an untrained model's NLL is 3.35-3.4 nats."""
    E, h = w["lstm_word_emb"], w["lstm_hidden"]
    hb = 1.0 / math.sqrt(h)
    out = [Leaf("text.embedding", (vocab, E), "normal"), Leaf("text.wx", (E, 4 * h), "uniform", hb),
           Leaf("text.wh", (h, 4 * h), "uniform", hb), Leaf("text.b", (4 * h,), "uniform", hb)]
    for l, (d, width) in enumerate(zip(g_input_dims(w), w["g_layers"])):
        b = 1.0 / math.sqrt(d)
        out += [Leaf(f"relational.g{l}_kernel", (d, width), "uniform", b),
                Leaf(f"relational.g{l}_bias", (width,), "uniform", b)]
    f = [w["g_layers"][-1], *w["f_layers"], w["n_answers"]]
    for l, (d, width) in enumerate(zip(f[:-1], f[1:])):
        b = 1.0 / math.sqrt(d)
        out += [Leaf(f"relational.f{l}_kernel", (d, width), "uniform", b),
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
        else:
            out[x.name] = nor[a_n:a_n + size].reshape(x.shape).clone()
            a_n += size
    return out


def parameter_names(w: Dict, vocab: int) -> List[str]:
    return [x.name for x in layout(w, vocab)]


def step_draws(gen: torch.Generator, B: int, f_hidden: int, device) -> torch.Tensor:
    """The dropout uniforms (B, f_hidden) of one training step."""
    return torch.rand((B, f_hidden), generator=gen, device=device)


def pooled_g(p: Dict[str, torch.Tensor], w: Dict, x: torch.Tensor, q: torch.Tensor,
             R: Precision = FLOAT32) -> torch.Tensor:
    """(b, n, c) objects, (b, h) question -> (b, H) g_theta summed over the
    n^2 ordered pairs, the question joined at layer 0. Layer 0 is u_i + v_j
    + s (u = x W0[:c], v = x W0[c:2c], s = b0 + q W0[2c:]), the same function
    as the concatenated row times W0. ``R`` rounds each result where the
    port's bf16 route rounds it: u, v, q W0[2c:] and s; u_i + v_j, then
    + s; each later layer's product, then + its bias; the pooled sum."""
    if w["question_injection_position"] != 0:
        raise ValueError("the reference joins the question at g layer 0 (as original-sd does)")
    b, n, c = x.shape
    W0 = R(p["relational.g0_kernel"])
    xr = R(x)
    u, v = R(xr @ W0[:c]), R(xr @ W0[c:2 * c])
    s = R(R(p["relational.g0_bias"]) + R(R(q) @ W0[2 * c:]))
    a = torch.relu(R(R(u[:, :, None, :] + v[:, None, :, :]) + s[:, None, None, :])).reshape(b, n * n, -1)
    for l in range(1, len(w["g_layers"])):
        a = torch.relu(R(R(a @ R(p[f"relational.g{l}_kernel"])) + R(p[f"relational.g{l}_bias"])))
    return R(a.sum(dim=1))


@torch.no_grad()
def log_probs(p: Dict[str, torch.Tensor], w: Dict, objects: torch.Tensor, tokens: torch.Tensor,
              R: Precision = FLOAT32, block: int = 64) -> torch.Tensor:
    """(B, n_answers) log-probs in eval mode of (B, n, 18) objects."""
    q = question_state(p, w, tokens)
    pooled = torch.cat([pooled_g(p, w, objects[s], q[s], R) for s in _blocks(objects.shape[0], block)])
    return head(p, w, pooled, None, 0.0)


def loss_and_grads(p: Dict[str, torch.Tensor], w: Dict, objects: torch.Tensor, tokens: torch.Tensor,
                   labels: torch.Tensor, drop_u: torch.Tensor, R: Precision = FLOAT32,
                   block: int = 64) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean NLL, gradient of every parameter) of a train-mode forward.
    g_theta is run in blocks of samples twice: once for the pooled sums,
    once more in its backward."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    qv = question_state(leaves, w, tokens)
    qd = qv.detach().requires_grad_()
    x = objects.float()
    blocks = _blocks(x.shape[0], block)
    with torch.no_grad():
        pooled = torch.cat([pooled_g(leaves, w, x[s], qd[s], R) for s in blocks])
    pd = pooled.requires_grad_()
    logp = head(leaves, w, pd, drop_u, w["dropout"])
    loss = -logp.gather(1, labels.long()[:, None]).mean()
    loss.backward()
    for s in blocks:
        torch.autograd.backward(pooled_g(leaves, w, x[s], qd[s], R), pd.grad[s])
    qv.backward(qd.grad)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}
    return loss.detach(), grads


def train_steps(p0: Dict[str, torch.Tensor], w: Dict, data: Dict[str, torch.Tensor], rows: Sequence[torch.Tensor],
                gen_seed: int, opt: Dict, R: Precision = FLOAT32, half_batch: bool = False,
                block: int = 64) -> Dict:
    """len(rows) training steps from the weights ``p0`` on the questions
    ``rows[t]`` of ``data`` (per-question ``objects``, ``question``,
    ``answer``), with the dropout draws of a generator seeded ``gen_seed``:
    each step's loss and gradient norm before the clip, the first step's
    clipped gradient (what Adam gets), and Adam's first moment and the
    parameters after the last step. ``half_batch``: the fault that drops
    the second half of every batch (the mean over the first half)."""
    dev = data["objects"].device
    names = list(p0)
    params = {k: v.detach().clone().float() for k, v in p0.items()}
    m = {k: torch.zeros_like(params[k]) for k in names}
    v2 = {k: torch.zeros_like(params[k]) for k in names}
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    b1, b2, eps, lr, clip = opt["b1"], opt["b2"], opt["eps"], opt["lr"], opt["clip_norm"]
    losses, norms, grad1 = [], [], None
    for t, idx in enumerate(rows, 1):
        idx = idx.long()
        u = step_draws(gen, idx.shape[0], w["f_layers"][-1], dev)
        objects, tokens, labels = data["objects"][idx], data["question"][idx], data["answer"][idx]
        if half_batch:
            k = idx.shape[0] // 2
            objects, tokens, labels, u = objects[:k], tokens[:k], labels[:k], u[:k]
        loss, g = loss_and_grads(params, w, objects, tokens, labels, u, R, block)
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
    return {"loss": losses, "grad_norm": norms, "grad1": grad1, "moment": m, "params": params}
