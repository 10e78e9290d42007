"""The controls of the hybrid (Mamba2 and attention) serving cells, each
at the cell's own size through the cell's own driver and comparison,
with a window of one batch (``WINDOW_S``):

* ``program``: the sound program: its readings are the lower ones;
* ``program_float32``: a witness, not a control: the port's model in
  float32 (``Model.float()``), prefilled and decoded greedily on the
  seed's first ``check_requests`` prompts outside the batcher, against
  the reference, which then differs from it by rounding alone;
* ``fp8_weights``: the reference with each bfloat16 matrix rounded to
  float8 e4m3 with one scale a tensor (the precision below the
  configuration's), put in the program's place over the sound run's
  sampled prompts and served tokens; at the attention stage, the
  reference's attention over the query and cache rows so rounded;
* ``state_zeroed``: the program with every Mamba2 layer's SSM state
  zeroed once, at the start of one decode step of each batch, halfway
  between the second and third compared steps (``zero_step``: 48 at
  steps 0, 32, 64, ...), a step at which no position is compared: what
  the later positions keep of the state is what shows;
* ``cache_short``: the program's decode attention reading one cache
  position short (``attended_length`` giving ``lengths``: the step's own
  key and value left out); the stage number ``attention`` is the one
  that can see it.

The faults are planted in the port's modules for the one run and
taken out after it.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager

from benchkit.compare import worst
from benchkit.record import Sample
from benchkit.spec import load_module

__all__ = ["WINDOW_S", "cache_short", "float32_witness", "readings", "state_zeroed_once",
           "zero_step"]

#: The window of each run: the first batch completed after the warm-up.
WINDOW_S = 1e-3


@contextmanager
def _attr(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextmanager
def state_zeroed_once(prompt_len: int, step: int):
    """Every Mamba2 layer's SSM state zeroed at the start of decode step
    ``step`` (the caches then hold ``prompt_len + step - 1`` tokens)."""
    from repro_torch.models import transformer

    decode_step = transformer.decode_step

    def faulty(p, caches, tokens, lengths, cfg):
        if int(lengths[0]) == prompt_len + step - 1:
            for cache in caches["mamba"]:
                cache["ssm"].zero_()
        return decode_step(p, caches, tokens, lengths, cfg)

    with _attr(transformer, "decode_step", faulty):
        yield


def zero_step(check_steps: list[int]) -> int:
    """The decode step (1-based) halfway between the second and third
    compared steps."""
    steps = sorted(check_steps)
    return (steps[1] + steps[2]) // 2


@contextmanager
def cache_short():
    """Decode attention over one cache position fewer than it should."""
    from repro_torch.models import attention

    with _attr(attention, "attended_length", lambda lengths: lengths):
        yield


def _run(cell, seed: int, device: str):
    driver = load_module("drivers", cell.config["driver"], cell.bench)
    record, samples = driver.run(cell, seed, WINDOW_S, False, device, time.perf_counter())
    del record
    gc.collect()
    return samples


def _free(device: str) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def float32_witness(cell, seed: int, device: str) -> list:
    """Samples of the port's model in float32 on the seed's first
    ``check_requests`` prompts, prefilled and decoded greedily through
    the port's steps: each request's logits at the compared steps and
    its tokens."""
    import numpy as np
    import torch

    from kinds.serve import make_prompts
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import Model, make_plan
    from repro_torch.train import make_prefill_step, make_serve_step

    cfg, tr, lim = cell.config, cell.traffic, cell.limits
    driver = load_module("drivers", cfg["driver"], cell.bench)
    reference = load_module("reference", cfg["reference"], cell.bench)
    port_cfg = (get_smoke_config if cfg.get("smoke") else get_config)(cfg["arch"])
    port_seed = int(seed) % 2**63
    batch = int(lim["check_requests"])
    plen, max_new = int(tr["prompt_len"]), int(tr["max_new"])
    prompts = make_prompts(dict(tr, requests=batch), port_seed, int(cfg["vocab_size"]))
    weights = reference.make_weights(cfg, port_seed, device)
    model = Model(port_cfg, make_plan(port_cfg), driver._nest(weights)).float()
    del weights
    steps = list(lim["check_steps"])
    with torch.no_grad():
        logits, caches = make_prefill_step(model, int(tr["max_len"]))(
            {"tokens": torch.as_tensor(prompts, device=device).long()})
        kept, served = {0: logits.cpu()}, [logits.argmax(-1)]
        lengths = torch.full((batch,), plen, dtype=torch.int32, device=device)
        tok, step = served[0].to(torch.int32), make_serve_step(model)
        for k in range(1, max_new):
            tok, logits, caches, lengths = step(caches, tok.long(), lengths)
            served.append(tok.long())
            if k in steps:
                kept[k] = logits.cpu()
    served = torch.stack(served, 1).cpu().numpy()
    del model, caches
    _free(device)
    out = []
    for j in range(batch):
        got = {"steps": steps, "served": served[j],
               "logits": np.stack([kept[s][j].float().numpy() for s in steps])}
        inputs = {"config": cfg, "seed": port_seed,
                  "tokens": np.concatenate([prompts[j].astype(np.int64), served[j][:max_new - 1]]),
                  "rows": [plen - 1 + i for i in range(max_new)]}
        out.append(Sample(j, inputs, got))
    return out


def readings(cell, seed: int, device: str, controls: bool = True) -> dict[str, dict[str, float]]:
    """The sound program's numbers and, with ``controls``, each
    control's and the float32 witness's, on ``seed``."""
    reference = load_module("reference", cell.config["reference"], cell.bench)
    comparison = load_module("compare", cell.config["compare"], cell.bench)

    def judged(samples, weights="as_configured"):
        out = []
        for s in samples:
            want = reference.run_sample(s.inputs, device)
            got = s.got
            if weights != "as_configured" and "attention" in got:  # the control's attention
                got = {"attention": reference.run_sample(s.inputs, device, weights=weights)}
            elif weights != "as_configured":  # the control's logits, and the tokens it puts first
                low = reference.run_sample(s.inputs, device, weights=weights)
                got = dict(got, logits=low[got["steps"]], served=low.argmax(-1))
            out.append(comparison.compare(got, want))
        return worst(out)

    out = {}
    samples = _run(cell, seed, device)
    _free(device)
    out["program"] = judged(samples)
    if not controls:
        return out
    out["fp8_weights"] = judged(samples, "fp8")
    _free(device)
    out["program_float32"] = judged(float32_witness(cell, seed, device))
    _free(device)
    with state_zeroed_once(int(cell.traffic["prompt_len"]), zero_step(cell.limits["check_steps"])):
        samples = _run(cell, seed, device)
    _free(device)
    out["state_zeroed"] = judged(samples)
    with cache_short():
        samples = _run(cell, seed, device)
    _free(device)
    out["cache_short"] = judged(samples)
    return out
