"""Elastic re-meshing: continue training on another number of ranks
(the port of ``repro/launch/elastic.py``).

When ranks are lost (or added), the survivors form a new mesh and the
training state moves onto it. The parameters and optimizer moments are
rule-laid chunks (``launch/sharding.py``), so elasticity is data
movement, not another code path::

    state = reshard_state(state, cfg, new_mesh, model=model)

Every leaf is gathered whole on the old mesh, then each rank of the new
mesh keeps its chunk (DTensor's ``Shard`` chunks of ``to_placements``).
``state.params`` are the model's own parameters: they take their new
chunks in place and the model is attached to the new mesh, so its train
step runs there next. On a real cluster the state would come from the
last checkpoint instead, with the same result.
"""

from __future__ import annotations

import torch

from ..models.config import ArchConfig
from ..models.convert import stacked_in_reference
from ..optim import Opt8State, OptState
from ..train import TrainState
from .mesh import Mesh, axes_for
from .sharding import param_specs
from .spmd import Spmd, gather_whole, shard_of

__all__ = ["reshard_state", "state_shardings"]


def _scale_spec(name: str, spec: tuple) -> tuple:
    """The 8-bit state's row scales: laid out by the leading dim only,
    which for one layer of a group the reference stacks is the
    (unsharded) layer dim."""
    if stacked_in_reference(name):
        return (None,) * len(spec)
    return tuple(spec[:1]) + (None,) * max(len(spec) - 1, 0)


def state_shardings(state: TrainState, cfg: ArchConfig, mesh, shapes=None) -> TrainState:
    """Spec tree of a ``TrainState`` on ``mesh`` (rule-derived): the
    moments reuse the parameters' specs; the 8-bit state's codes too,
    its scales the leading dim only. ``shapes``: the parameters' whole
    shapes, where ``state.params`` holds chunks."""
    shapes = shapes or {k: tuple(v.shape) for k, v in state.params.items()}
    pspecs = param_specs({k: torch.empty(s, device="meta") for k, s in shapes.items()},
                         cfg, axes_for(mesh), mesh)
    if isinstance(state.opt, OptState):
        ospecs = OptState(step=(), mu=pspecs, nu=pspecs)
    else:
        sspecs = {k: _scale_spec(k, s) for k, s in pspecs.items()}
        ospecs = Opt8State(step=(), mu_q=pspecs, mu_s=sspecs, nu_q=pspecs, nu_s=sspecs)
    return TrainState(params=pspecs, opt=ospecs)


def reshard_state(state: TrainState, cfg: ArchConfig, new_mesh: Mesh, *,
                  model) -> TrainState | None:
    """Move ``state`` (``model``'s, laid out on ``model.spmd.mesh``) onto
    ``new_mesh``. Every rank of the old mesh must call it. The model
    axis keeps its size (the padded attention slots depend on it); the
    data axes may shrink or grow. Returns the state on ``new_mesh``, or
    None on a rank outside it."""
    tp = axes_for(new_mesh).model_size(new_mesh)
    if tp != model.plan.tp:
        raise ValueError(f"the new mesh's model axis is {tp}, the model's plan tp="
                         f"{model.plan.tp}: only the data axes change size")
    old = model.spmd
    shapes = old.shapes
    before = state_shardings(state, cfg, old.mesh, shapes)
    after = state_shardings(state, cfg, new_mesh, shapes)

    def move(t, spec_old, spec_new):
        whole = gather_whole(t, spec_old, old.mesh)
        return shard_of(whole, spec_new, new_mesh).clone() if new_mesh.member else None

    def move_tree(tree, sp_old, sp_new):
        return {k: move(v, sp_old[k], sp_new[k]) for k, v in tree.items()}

    with torch.no_grad():
        params = {}
        for k, p in state.params.items():
            t = move(p.data, before.params[k], after.params[k])
            if t is not None:
                p.data = t
                params[k] = p
        fields = {}
        for f in state.opt._fields:
            leaf = getattr(state.opt, f)
            if isinstance(leaf, dict):
                fields[f] = move_tree(leaf, getattr(before.opt, f), getattr(after.opt, f))
            else:  # the step count, replicated
                fields[f] = leaf
    if not new_mesh.member:
        return None
    model.spmd = Spmd(model, new_mesh, shapes)
    return TrainState(params, type(state.opt)(**fields))

