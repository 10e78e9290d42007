"""Jobs of ``tests/test_torch_distributed.py``, run by spawned ``gloo``
ranks on the CPU (this module imports no JAX: each rank imports it).

``spawn(job, world, tmp, args)`` starts ``world`` ranks with a
``file://`` rendezvous under ``tmp`` (no ports), runs ``JOBS[job](rank,
world, args)`` in each and returns rank 0's result; a rank that raises
or outlives the time limit fails the call, and every rank is stopped.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = 120.0


def _rank(rank, world, init, job, args_path, out_dir):
    import datetime

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        res = JOBS[job](rank, world, args)
        if rank == 0:
            torch.save(res, Path(out_dir) / "result.pt")
    except BaseException:
        (Path(out_dir) / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, tmp: Path, args: dict, timeout: float = TIMEOUT):
    out = Path(tmp) / job
    out.mkdir(parents=True, exist_ok=True)
    args_path = out / "args.pkl"
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, str(out / "rendezvous"), job,
                                             str(args_path), str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            errors = sorted(out.glob("error_*.txt"))
            if failed or errors:
                detail = "\n".join(e.read_text() for e in errors)
                raise RuntimeError(f"{job}: a rank failed ({failed})\n{detail}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job}: ranks still running after {timeout:.0f} s")
            time.sleep(0.05)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            detail = "\n".join(e.read_text() for e in sorted(out.glob("error_*.txt")))
            raise RuntimeError(f"{job}: rank exit codes {codes}\n{detail}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    return torch.load(out / "result.pt", weights_only=False)


# --------------------------------------------------------------------------
# helpers (in the ranks)
# --------------------------------------------------------------------------


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _mesh(shape, world):
    """A mesh of ``shape`` over the first ranks of the world (every rank
    calls it)."""
    from repro_torch.launch.mesh import make_mesh

    n = int(np.prod(shape))
    return make_mesh(shape, _axes(shape), "cpu", ranks=range(n) if n < world else None)


def _model(cfg, state: dict, trainable: bool = True):
    from repro_torch.models import build_model, make_plan

    model = build_model(cfg, make_plan(cfg, tp=1), device="cpu", seed=3, trainable=trainable,
                        act_dtype=torch.float32)
    if not trainable:
        model = model.float()
    model.load_state_dict(state)
    return model


def _sharded(cfg, state: dict, mesh, trainable: bool = True):
    """The whole model from ``state``, this rank's chunks kept on ``mesh``."""
    from repro_torch.launch.mesh import axes_for
    from repro_torch.launch.spmd import distribute
    from repro_torch.models import build_model, make_plan

    tp = axes_for(mesh).model_size(mesh)
    model = build_model(cfg, make_plan(cfg, tp=tp), device="cpu", seed=3, trainable=trainable,
                        act_dtype=torch.float32)
    if not trainable:
        model = model.float()
    model.load_state_dict(state)
    return distribute(model, mesh)


def _whole(model, tree: dict) -> dict:
    from repro_torch.launch.spmd import gather_whole

    sp = model.spmd
    return {k: gather_whole(t.detach(), sp.specs[k], sp.mesh).clone() for k, t in tree.items()}


def _step(model, batch, opt):
    """One step on a sharded model -> whole loss, gradients, new weights,
    the global norm and the optimizer state."""
    from repro_torch.optim import global_norm
    from repro_torch.train import loss_and_grads

    params = dict(model.named_parameters())
    loss, metrics, grads = loss_and_grads(model, batch)
    norm = global_norm(grads, model.spmd)
    grads_whole = _whole(model, grads)
    state = opt.init(params)
    _, state = opt.update(grads, state, params, shards=model.spmd)
    out = dict(loss=float(loss), aux=float(metrics["aux"]), grads=grads_whole,
               new=_whole(model, params), norm=float(norm))
    return out, state


# --------------------------------------------------------------------------
# jobs
# --------------------------------------------------------------------------


def train_job(rank, world, args):
    """One float32 step of each model on each of its meshes; AdamW8bit
    and a binding clip on ``opt_mesh``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.elastic import state_shardings
    from repro_torch.launch.spmd import gather_whole
    from repro_torch.optim import AdamW, AdamW8bit
    from repro_torch.train import TrainState

    out = {}
    for shape in args["meshes"]:
        mesh = _mesh(shape, world)
        for arch, (state, batch, shapes) in args["models"].items():
            if not mesh.member or shape not in shapes:
                continue
            cfg = get_smoke_config(arch)
            model = _sharded(cfg, state, mesh)
            out[arch, shape], _ = _step(model, batch, AdamW(lr=args["lr"]))
    shape = args["opt_mesh"]
    mesh = _mesh(shape, world)
    if mesh.member:
        arch = args["opt_arch"]
        state, batch, _ = args["models"][arch]
        cfg = get_smoke_config(arch)
        for name, opt in (("adamw8bit", AdamW8bit(lr=args["lr"])),
                          ("clip", AdamW(lr=args["lr"], clip_norm=args["clip_norm"]))):
            model = _sharded(cfg, state, mesh)
            res, ostate = _step(model, batch, opt)
            if name == "adamw8bit":
                shapes = model.spmd.shapes
                specs = state_shardings(TrainState(dict(model.named_parameters()), ostate),
                                        cfg, mesh, shapes).opt
                res["opt"] = {f: {k: gather_whole(t, getattr(specs, f)[k], mesh)
                                  for k, t in getattr(ostate, f).items()}
                              for f in ("mu_q", "mu_s", "nu_q", "nu_s")}
            out[name] = res
    return out


def serve_elastic_job(rank, world, args):
    """Prefill and greedy decode on (1, 2); then elastic (2, 2) -> (1, 2)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.elastic import reshard_state
    from repro_torch.launch.spmd import gather_whole
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_serve_step, make_train_step

    out = {"serve": {}}
    mesh = _mesh((1, 2), world)
    for arch, (state, toks) in args["serve"].items():
        if not mesh.member:
            continue
        model = _sharded(get_smoke_config(arch), state, mesh, trainable=False)
        p = args["prompt"]
        logits, caches = model.prefill({"tokens": toks[:, :p]}, p + args["steps"])
        step = make_serve_step(model)
        lengths = torch.full((toks.shape[0],), p, dtype=torch.int32)
        seq, toks_out = [logits], []
        for _ in range(args["steps"]):
            nxt = seq[-1].argmax(-1).to(torch.int32)
            toks_out.append(nxt)
            _, logits, caches, lengths = step(caches, nxt, lengths)
            seq.append(logits)
        out["serve"][arch] = dict(logits=torch.stack(seq), tokens=torch.stack(toks_out),
                                  slots=caches["kv"][0]["k"].shape[1])
    e = args["elastic"]
    cfg = get_smoke_config(e["arch"])
    mesh_a, mesh_b = _mesh((2, 2), world), _mesh((1, 2), world)
    model = _sharded(cfg, e["state"], mesh_a)
    opt = AdamW(lr=e["lr"])
    params = dict(model.named_parameters())
    tstate = TrainState(params, opt.init(params))
    step = make_train_step(model, opt)
    losses = []
    for _ in range(e["steps"]):
        tstate, m = step(tstate, {"tokens": e["tokens"]})
        losses.append(float(m["loss"]))
    tstate = reshard_state(tstate, cfg, mesh_b, model=model)
    if tstate is not None:
        for _ in range(e["steps"]):
            tstate, m = step(tstate, {"tokens": e["tokens"]})
            losses.append(float(m["loss"]))
        out["elastic"] = dict(losses=losses, params={
            k: gather_whole(p.detach(), model.spmd.specs[k], mesh_b)
            for k, p in tstate.params.items()}, ranks=mesh_b.size)
    return out


def _leaf_shapes(tree):
    if isinstance(tree, dict):
        return {k: _leaf_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_shapes(v) for v in tree]
    return tuple(tree.shape)


def serve_mesh_job(rank, world, args):
    """Each case: the global batch prefilled on every rank of its mesh
    (which keeps the rank's rows and its chunk of the caches, checked
    against the layout of ``init_caches``), then greedy decode steps on
    the rank's rows (all of them where the data axes do not divide the
    batch: the long-context layout). -> the whole logits and tokens per
    case, and whether the model was back in the training layout after
    it; then ``args["int8"]``'s chain of the int8 KV cache from empty
    caches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.spmd import ROWS_SPLIT
    from repro_torch.train import make_serve_step

    out = {}
    for c in args["cases"]:
        mesh = _mesh(c["mesh"], world)  # every rank calls it
        if not mesh.member:
            continue
        arch, batch, p = c["arch"], c["batch"], c["prompt"]
        model = _sharded(get_smoke_config(arch), args["states"][arch], mesh, trainable=False)
        sp = model.spmd
        inputs = dict(args["inputs"][arch, batch])
        inputs["tokens"] = inputs["tokens"][:, :p]
        mine, caches = model.prefill(inputs, c["max_len"])
        same = _leaf_shapes(caches) == _leaf_shapes(model.init_caches(batch, c["max_len"]))
        layout = sp.serve_layout(batch, c["max_len"])
        split = layout.rows_split
        rows = (lambda t: sp.data.chunk(t, 0)) if split else (lambda t: t)  # noqa: E731
        join = (lambda t: sp.data.all_gather(t, 0)) if split else (lambda t: t)  # noqa: E731
        step = make_serve_step(model, layout)
        lengths = rows(torch.full((batch,), p, dtype=torch.int32))
        seq, toks = [join(mine)], []
        for _ in range(c["steps"]):
            nxt = mine.argmax(-1).to(torch.int32)
            toks.append(join(nxt))
            _, mine, caches, lengths = step(caches, nxt, lengths)
            seq.append(join(mine))
        out[c["key"]] = dict(logits=torch.stack(seq), tokens=torch.stack(toks), layout=same,
                             long=layout.seq is not None, rows_split=split,
                             reset=sp.layout is ROWS_SPLIT)
    q = args["int8"]  # the int8 KV cache in the long-context layout, from empty caches
    mesh = _mesh(q["mesh"], world)
    if mesh.member:
        from repro_torch.models.attention import attention_options

        model = _sharded(get_smoke_config(q["arch"]), args["states"][q["arch"]], mesh,
                         trainable=False)
        layout = model.spmd.serve_layout(1, q["max_len"])
        with attention_options(kv_quant=True):
            caches = model.init_caches(1, q["max_len"])
            step = make_serve_step(model, layout)
            lengths, seq = torch.zeros((1,), dtype=torch.int32), []
            for t in q["tokens"]:
                _, logits, caches, lengths = step(caches, t[None], lengths)
                seq.append(logits)
        out["int8"] = dict(logits=torch.stack(seq), long=layout.seq is not None,
                           int8="k_q" in caches["kv"][0])
    return out


def ef_job(rank, world, args):
    """``ef_roundtrip`` on each rank's row of the inputs; then
    ``make_compressed_dp_grads`` on (world, 1)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import ef_roundtrip
    from repro_torch.train import loss_and_grads, make_compressed_dp_grads

    mesh = _mesh((world, 1), world)
    comm = mesh.comm("data")
    g = torch.as_tensor(args["g"][rank])
    err = torch.as_tensor(args["err"][rank])
    mean, new_err = ef_roundtrip(g, err, comm)
    out = dict(mean=mean, new_err=new_err)

    cfg = get_smoke_config(args["arch"])
    model = _model(cfg, args["state"])
    toks = args["tokens"]
    _, _, local = loss_and_grads(model, {"tokens": toks.chunk(world)[rank]})
    from repro_torch.launch.sharding import reference_path

    stacked = {}
    for k, t in local.items():
        stacked.setdefault(reference_path(k), []).append(t.abs().max())
    scale = {p: comm.all_reduce(torch.stack(m).max() / 127.0 + 1e-12, "max")
             for p, m in stacked.items()}
    scales = {k: scale[reference_path(k)] for k in local}
    fn = make_compressed_dp_grads(model, mesh, ("data",))
    zero = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    grads, new_err, loss = fn({"tokens": toks}, zero)
    out.update(grads=grads, grad_err=new_err, loss=float(loss), scales=scales)
    return out


def card_step_job(rank, world, args):
    """One float32 step of a smoke model on (1, 2) with both ranks on the
    card (``gloo``, staged through host memory), and on rank 0 the same
    step on one rank: -> both, whole, on the host."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import loss_and_grads

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    cfg = get_smoke_config(args["arch"])
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    toks = args["tokens"].to(dev)
    build = lambda **kw: build_model(cfg, device=dev, seed=7, trainable=True,  # noqa: E731
                                     act_dtype=torch.float32, **kw)
    ops.reset_launch_counts()
    model = build(mesh=mesh)
    sharded, _ = _step(model, {"tokens": toks}, AdamW(lr=args["lr"]))
    out = dict(sharded=sharded, launches=ops.launch_counts(),
               staged=dict(mesh.comm("model").staged))
    if rank == 0:
        one = build()
        params = dict(one.named_parameters())
        loss, _, grads = loss_and_grads(one, {"tokens": toks})
        kept = {k: g.clone() for k, g in grads.items()}
        opt = AdamW(lr=args["lr"])
        opt.update(grads, opt.init(params), params)
        out["one"] = dict(loss=float(loss), grads=kept,
                          new={k: p.detach().clone() for k, p in params.items()})
    return _to_host(out)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


JOBS = {"train": train_job, "serve_elastic": serve_elastic_job, "ef": ef_job,
        "card_step": card_step_job, "serve_mesh": serve_mesh_job}
