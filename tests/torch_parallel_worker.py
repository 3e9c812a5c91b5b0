"""One rank of a gloo process group on the CPU, for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py JOB.json RANK

``JOB.json`` holds the process group (``init``: a ``file://`` URL, ``world``)
and a list of ``tasks``; each writes ``<out>/<task name>.<rank>.pkl``, a dict
of numpy arrays and plain values. Imports torch, numpy and ``rnet_torch``
only (never JAX or ``rnet``), as a multi-GPU run of the port does.

Tasks:
  * ``mesh``: the rank's coordinates, shard id, pair rows and groups;
  * ``core``: ``pairwise_core_sharded`` on the rank's shard of seeded
    inputs, its output and the six gradients of sum(out * r); with a
    ``pairs`` axis also the int8 core and each shard's calibration scales;
    with pair dropout, the output and gradients at keep 0.75;
  * ``step``: one train step of a shrunk model from saved weights on the
    rank's rows of a global batch: parameters, BatchNorm statistics, Adam
    moments and metrics after it;
  * ``trainer``: ``Trainer.fit`` on a CLEVR directory with decoded
    caches: the history, the parameters and the checkpoint files;
  * ``cli``: ``python -m rnet_torch.train``'s ``main(argv)`` in the joined
    group: its return code, or the exception it raised.
"""

from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rnet_torch import convert  # noqa: E402
from rnet_torch.config import load_config  # noqa: E402
from rnet_torch.kernels import pairwise as pw  # noqa: E402
from rnet_torch.models import RN  # noqa: E402
from rnet_torch.parallel import mesh as pmesh  # noqa: E402
from rnet_torch.train import steps  # noqa: E402

GRADS = ("du", "dv", "ds", "dqa", "dws", "dbs")


def _cfg(name, kw):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    return load_config(name, overrides={"compute_dtype": "float32"}).replace(**kw)


def task_mesh(task):
    out = {}
    for spec in task["specs"]:
        m = pmesh.make_mesh(spec, "cpu")
        out[spec] = {"coords": m.coords, "shard_id": m.shard_id, "world": m.world,
                     "pair_rows": (m.pair_rows(task["n"]).start, m.pair_rows(task["n"]).stop),
                     "data": (m.index("data"), m.size("data")), "pairs": (m.index("pairs"), m.size("pairs"))}
    return out


def _core(args, inject, mesh, r, **kw):
    leaves = [t.clone().requires_grad_(True) for t in args]
    out = pw.pairwise_core_sharded(*leaves, inject=inject, mesh=mesh, **kw)
    (out * r).sum().backward()
    return {"out": out.detach().numpy(), **{k: t.grad.numpy() for k, t in zip(GRADS, leaves)}}


def task_core(task):
    data = np.load(task["inputs"])
    inject = int(task["inject"])
    out = {}
    for spec in task["specs"]:
        mesh = pmesh.make_mesh(spec, "cpu")
        u, v, s, qa, r = (pmesh.shard_batch(torch.from_numpy(data[k]), mesh) for k in ("u", "v", "s", "qa", "r"))
        ws, bs = torch.from_numpy(data["ws"]), torch.from_numpy(data["bs"])
        args = (u, v, s, qa, ws, bs)
        res = {"core": _core(args, inject, mesh, r)}
        seed = torch.tensor([int(task["seed"])], dtype=torch.int64)
        res["dropout"] = _core(args, inject, mesh, r, pair_keep=0.75, seed=seed)
        if mesh.size("pairs") > 1:
            rows = mesh.pair_rows(u.shape[1], exact=True)
            res["int8"] = pw.pairwise_core_sharded(*args, inject=inject, mesh=mesh, int8=True).numpy()
            res["scales"] = pw.activation_scales(u[:, rows], v, s, qa, ws, bs, inject).numpy()
        res["shard_id"] = mesh.shard_id
        out[spec] = res
    return out


def task_step(task):
    cfg = _cfg(task["model"], task["cfg"])
    batch = dict(np.load(task["batch"]))
    weights = torch.load(task["weights"], weights_only=True)
    out = {}
    for spec in task["specs"]:
        for impl in task["impls"]:
            mesh = pmesh.make_mesh(spec, "cpu")
            model = RN(cfg.replace(rl_impl=impl), int(task["vocab"]), mesh=mesh)
            model.load_state_dict(weights)
            state = steps.create_train_state(model, steps.make_optimizer(task["lr"]))
            local = pmesh.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh)
            metrics = steps.train_step(state, local)
            out[f"{spec}/{impl}"] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "flax": convert.state_dict_to_flax(model.state_dict()),
                "adam": convert.adam_state_to_flax(model, state.adam),
                "state": {k: v.numpy().copy() for k, v in model.state_dict().items()},
            }
    return out


def task_trainer(task):
    from rnet_torch.data.cache import CachedClevrDataset
    from rnet_torch.data.vocab import build_dictionaries
    from rnet_torch.train.loop import Trainer
    from rnet_torch.train.schedules import DoublingSchedule

    dicts = build_dictionaries(task["clevr_dir"])
    cfg = _cfg(task["model"], dict(task["cfg"], n_answers=dicts.n_answers))
    out = {}
    for run in task["runs"]:
        ds_kw = dict(image_size=cfg.image_size, question_max_len=cfg.question_max_len, serve_padded=True,
                     serve_indices=True)
        train_ds = CachedClevrDataset(task["clevr_dir"], "train", dicts, train_transform=True, **ds_kw)
        val_ds = CachedClevrDataset(task["clevr_dir"], "val", dicts, train_transform=False, **ds_kw)
        ckpt = os.path.join(task["out"], f"ckpt_{run['name']}")
        tr = Trainer(
            cfg.replace(**{k: tuple(v) if isinstance(v, list) else v for k, v in run.get("cfg", {}).items()}),
            dicts.vocab_size, train_ds, val_ds, dicts,
            lr=DoublingSchedule(base=task["lr"], gamma=1.0, step=0), bs=DoublingSchedule(base=task["bs"], gamma=1.0, step=0),
            checkpoint_dir=ckpt, log_interval=2, log_fn=lambda *a: None, seed=7,
            device_data=run["device_data"], device="cpu", mesh_spec=run["spec"], num_threads=1,
        )
        history = tr.fit(task["epochs"])
        out[run["name"]] = {
            "history": history,
            "state": {k: v.numpy().copy() for k, v in tr.state.model.state_dict().items()},
            "ckpts": sorted(os.listdir(ckpt)),
        }
    return out


def task_cli(task):
    from rnet_torch.train.__main__ import main

    try:
        return {"rc": main(task["argv"])}
    except (Exception, SystemExit) as e:
        return {"raised": f"{type(e).__name__}: {e}"}


TASKS = {"mesh": task_mesh, "core": task_core, "step": task_step, "trainer": task_trainer, "cli": task_cli}


def main() -> int:
    with open(sys.argv[1]) as f:
        job = json.load(f)
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    pmesh.distributed_init("cpu", init_method=job["init"], world_size=job["world"], rank=rank)
    try:
        for task in job["tasks"]:
            task.setdefault("out", job["out"])
            result = TASKS[task["kind"]](task)
            with open(os.path.join(job["out"], f"{task['name']}.{rank}.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
