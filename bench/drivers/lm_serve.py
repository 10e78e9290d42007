"""Driver of the language-model serving cells: the port's batcher,
``repro_torch.launch.serve.serve_requests``, as ``python -m
repro_torch.launch.serve`` runs it.

The batcher admits ``batch_size`` requests once the decode batch has
drained, prefills them in one call, then decodes one token a step until
each has ``max_new`` tokens. The driver calls it with the traffic's
sizes and a backlog (``requests``) far longer than any window, queued
at the start, and observes it through the four names the loop looks up
in its module, each replaced for the run and restored after it:

* ``build_model``: the model of the configuration, built from the
  weights that the reference module makes from the seed
  (``make_weights``), after checking that the port's configuration has
  the file's numbers;
* ``make_prefill_step`` and ``make_serve_step``: the port's own steps,
  wrapped to time each step, keep the logits of a few requests a batch
  drawn from the seed at the limits file's ``check_steps``, and open
  and close the window;
* ``Request``: the port's request, which the driver keeps to read the
  loop's own times (``t_first``, ``t_done``) and the tokens the host
  received;

and, in ``repro_torch.kernels.ops``, ``decode_attention``, whose inputs
and output it copies at one step of the window's first batch (below).

The window opens at the admission after the warm-up batch completed
(the host's receipt of its last tokens) and closes at the first batch
completion at least ``seconds`` later; at the next admission the loop
is stopped, between steps. Both ends are noticed there, after the loop
read the batch's last tokens, so the counters, the memory peak (reset
at the opening) and the profiler belong to the window alone. A static
batch's memory is flat, so the peak is the whole window's.

The decode is bound by the host's pace of launches, so on the card the
run keeps the host steady: torch's own CPU pools at ``HOST_THREADS``
threads, and, at the opening, what set-up left collected and frozen
(``gc.freeze``), so that no collection in the window walks it.

With ``trace`` the driver records a span around each step's call
(``op:prefill``, ``op:decode``, on ``time.time``), by which the
breakdown names the device's idle gaps.

After the window each admitted batch's prompts are held to the
traffic's (``kinds.serve.make_prompts``), and ``check_requests`` of the
window's requests are drawn from the seed among the kept ones: each
sample is the prompt and the tokens the program served, the positions
compared, and the program's logits there.

A stage sample follows each kept request of the window's first batch:
at its last compared decode step, the query, the cache rows that the
step should attend to (as many as the harness counts: the prompt and
every token fed back, the step's own included) and the output of each
of the step's ``decode_attention`` calls, as the program made them.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager

from benchkit.record import Item, Run, Sample
from benchkit.spec import load_module
from kinds.serve import Batch, ServeRecord, make_prompts, rng_for

__all__ = ["run"]

#: Batches served before the window opens.
WARM_BATCHES = 1
#: Threads of torch's CPU pools on the card (the serving path launches
#: kernels from one thread and computes nothing on the host).
HOST_THREADS = 1


class _Closed(Exception):
    """Raised at the admission after the window closed: ends the loop."""


def _nest(flat: dict) -> dict:
    """``{"blocks.3.mamba.in_proj": t}`` -> nested dicts, with lists where
    the keys are indices (the port's parameter tree)."""
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _check_config(port_cfg, cfg: dict) -> None:
    """The port's configuration has every number of the file that it names."""
    wrong = {k: (getattr(port_cfg, k), v) for k, v in cfg.items()
             if hasattr(port_cfg, k) and k != "name" and getattr(port_cfg, k) != v}
    if wrong:
        raise ValueError(f"the port's {port_cfg.name} differs from the configuration file "
                         f"(port, file): {wrong}")


class _Window:
    """The window's two ends and the steps' hooks."""

    def __init__(self, seconds: float, keep_steps: list[int], keep_per_batch: int,
                 seed: int, batch_size: int, prompt_len: int, dev, profiler, trace: bool) -> None:
        import torch

        self.seconds, self.keep_steps, self.dev = seconds, set(keep_steps), dev
        self.prompt_len, self.stage_step = prompt_len, max(keep_steps)
        self.capture = None                # (rows, positions) while a stage step runs
        self.stage: list[dict] = []        # each decode_attention call of that step
        self.keep_per_batch, self.seed, self.batch_size = keep_per_batch, seed, batch_size
        self.cuda = torch.cuda if dev.type == "cuda" else None
        self.profiler, self.trace = profiler, None
        self.requests: list = []
        self.batches: list[Batch] = []
        self.prompts: list = []            # each batch's prompts as the program got them
        self.kept: list[dict] = []         # each batch's kept logits by step
        self.keep_rows: list[list[int]] = []
        self.opened = self.closed = False
        self.t_open = self.t_close = self.wall_open = 0.0
        self.window_peak = 0
        self.spans: list[dict] | None = [] if trace else None

    def _span(self, name: str, t0: float, batch: int) -> None:
        if self.spans is not None:
            self.spans.append({"name": name, "ts": t0, "dur": time.time() - t0,
                               "args": {"batch": batch}})

    def _completion(self) -> float:
        b = self.batches[-1]
        reqs = self.requests[b.rids[0]:b.rids[-1] + 1]
        b.t_first = max(r.t_first for r in reqs)
        b.t_done = max(r.t_done for r in reqs)
        return b.t_done

    def admission(self) -> None:
        """At each admission, between two batches: the window opens after
        the warm-up, and closes at the first completion ``seconds`` after
        it opened (the loop then stops)."""
        if not self.batches:
            return
        done = self._completion()
        if not self.opened and len(self.batches) == WARM_BATCHES:
            if self.cuda is not None:
                gc.collect()
                gc.freeze()
            self.opened, self.t_open, self.wall_open = True, time.monotonic(), time.time()
            if self.cuda is not None:
                self.cuda.reset_peak_memory_stats(self.dev)
            if self.profiler is not None:
                self.profiler.start()
        elif self.opened and done - self.t_open >= self.seconds:
            self.closed, self.t_close = True, done
            if self.cuda is not None:
                self.window_peak = self.cuda.max_memory_allocated(self.dev)
            if self.profiler is not None:
                self.trace = self.profiler.stop()
            raise _Closed

    def prefill(self, step):
        import torch

        def hooked(inputs):
            self.admission()
            index = len(self.batches)
            n = inputs["tokens"].shape[0]
            first = index * self.batch_size
            rows = sorted(int(i) for i in rng_for(self.seed, 4, index).choice(
                n, size=min(self.keep_per_batch, n), replace=False))
            self.batches.append(Batch(index, list(range(first, first + n)), time.monotonic()))
            self.prompts.append(inputs["tokens"])
            self.keep_rows.append(rows)
            self._rows = torch.as_tensor(rows, device=inputs["tokens"].device)
            t0 = time.time()
            logits, caches = step(inputs)
            kept = {0: logits.index_select(0, self._rows)} if 0 in self.keep_steps else {}
            self.kept.append(kept)
            self._span("op:prefill", t0, index)
            return logits, caches

        return hooked

    def decode(self, step):
        def hooked(caches, tokens, lengths):
            b = self.batches[-1]
            b.decode_steps += 1
            if b.index == WARM_BATCHES and b.decode_steps == self.stage_step:
                self.capture = (self._rows, self.prompt_len + b.decode_steps)
            t0 = time.time()
            nxt, logits, caches, lengths = step(caches, tokens, lengths)
            self.capture = None
            if b.decode_steps in self.keep_steps:
                self.kept[-1][b.decode_steps] = logits.index_select(0, self._rows)
            self._span("op:decode", t0, b.index)
            return nxt, logits, caches, lengths

        return hooked

    def attention(self, fn):
        """``decode_attention``, copying the kept rows' query, cache rows
        and output while a stage step runs."""
        def hooked(q, k, v, lengths, *args, **kw):
            out = fn(q, k, v, lengths, *args, **kw)
            if self.capture is not None:
                rows, n = self.capture
                o = out[0] if isinstance(out, tuple) else out
                self.stage.append({"q": q.index_select(0, rows),
                                   "k": k[:, :, :n].index_select(0, rows),
                                   "v": v[:, :, :n].index_select(0, rows),
                                   "out": o.index_select(0, rows)})
            return out

        return hooked


@contextmanager
def _patched(module, **names):
    old = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> tuple[Run, list[Sample]]:
    """One run of ``cell`` on prompts and weights made from ``seed``:
    returns the :class:`Run` and ``check_requests`` samples of the
    window's requests (drawn from ``seed``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Model, make_plan

    cfg, tr, lim = cell.config, cell.traffic, cell.limits
    reference = load_module("reference", cfg["reference"], cell.bench)
    dev = torch.device(device)
    port_seed = int(seed) % 2**63
    prompts = make_prompts(tr, port_seed, int(cfg["vocab_size"]))
    batch_size = int(cfg["serve"]["batch_size"])

    def build_model(port_cfg, device=None, seed=None, **_):
        _check_config(port_cfg, cfg)
        weights = reference.make_weights(cfg, port_seed, dev)
        return Model(port_cfg, make_plan(port_cfg), _nest(weights))

    profiler = None
    if trace and dev.type == "cuda":
        from benchkit.trace import Profiler

        first_session = Profiler()  # pays the profiler's own set-up
        first_session.start()
        torch.ones(1, device=dev).add_(1)
        first_session.stop()
        profiler = Profiler()
    window = _Window(seconds, lim["check_steps"], int(lim["check_requests"]), seed, batch_size,
                     int(tr["prompt_len"]), dev, profiler, trace)

    class Request(serve.Request):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            window.requests.append(self)

    prefill_of, serve_of = serve.make_prefill_step, serve.make_serve_step
    threads = torch.get_num_threads()
    if dev.type == "cuda":
        torch.set_num_threads(HOST_THREADS)
    with _patched(serve, build_model=build_model, Request=Request,
                  make_prefill_step=lambda model, *a: window.prefill(prefill_of(model, *a)),
                  make_serve_step=lambda model, *a: window.decode(serve_of(model, *a))), \
            _patched(ops, decode_attention=window.attention(ops.decode_attention)):
        try:
            serve.serve_requests(arch=cfg["arch"], smoke=bool(cfg.get("smoke", False)),
                                 n_requests=int(tr["requests"]), batch_size=batch_size,
                                 prompt_len=int(tr["prompt_len"]), max_new=int(tr["max_new"]),
                                 max_len=int(tr["max_len"]), seed=port_seed, device=dev)
        except _Closed:
            pass
        finally:
            gc.unfreeze()
            torch.set_num_threads(threads)
    if not window.closed:
        raise RuntimeError(f"the window did not close: {len(window.batches)} batches of the "
                           f"backlog's {tr['requests']} requests served in all")
    errors = _prompt_errors(window, prompts)
    return _record(window, cell, t_start, errors), _samples(window, cell, prompts, seed, port_seed)


def _prompt_errors(window: _Window, prompts) -> list[str]:
    """Each admitted batch whose prompts, as the program got them, are
    not the traffic's."""
    import numpy as np

    return [f"batch {b.index}: the prompts prefilled differ from the traffic's"
            for b, got in zip(window.batches, window.prompts)
            if not np.array_equal(got.cpu().numpy(), prompts[b.rids[0]:b.rids[-1] + 1])]


def _record(window: _Window, cell, t_start: float, errors: list[str]) -> Run:
    cfg, tr = cell.config, cell.traffic
    own = ServeRecord(model=cfg, prompt_len=int(tr["prompt_len"]),
                      batch_size=int(cfg["serve"]["batch_size"]),
                      ssd_chunk=int(cfg["serve"]["ssd_chunk"]), batches=window.batches)
    items = {}
    for b in window.batches:
        for rid in b.rids:
            r = window.requests[rid]
            items[rid] = Item(rid, b.t_admit, r.t_done or None)
            own.first[rid] = r.t_first
            own.tokens[rid] = len(r.out_tokens)
    return Run(t_open=window.t_open, t_close=window.t_close, wall_open=window.wall_open,
               setup_s=window.t_open - (t_start + (time.monotonic() - time.perf_counter())),
               items=items, counters_open={}, counters_close={},
               peak_bytes=int(window.window_peak), window_peak_bytes=int(window.window_peak),
               spans=window.spans or [], device=window.trace, errors=errors, own=own)


def _samples(window: _Window, cell, prompts, seed: int, port_seed: int) -> list[Sample]:
    """``check_requests`` requests of the window's batches, drawn from the
    seed among those whose logits were kept: each with its prompt and the
    tokens fed back (``tokens``), the positions at which each served
    token was chosen (``rows``), and the program's logits at the
    compared steps and every token it served."""
    import numpy as np

    tr, lim = cell.traffic, cell.limits
    plen, max_new, steps = int(tr["prompt_len"]), int(tr["max_new"]), list(lim["check_steps"])
    cands = [(b.index, j) for b in window.batches
             if b.t_done and window.t_open <= b.t_admit and b.t_done <= window.t_close
             for j in range(len(window.keep_rows[b.index]))]
    k = min(int(lim["check_requests"]), len(cands))
    picks = rng_for(seed, 3).choice(len(cands), size=k, replace=False) if k else []
    out = []
    for p in sorted(int(i) for i in picks):
        bi, j = cands[p]
        rid = window.batches[bi].rids[window.keep_rows[bi][j]]
        served = np.asarray(window.requests[rid].out_tokens, np.int64)
        got = {"steps": steps, "served": served,
               "logits": np.stack([window.kept[bi][s][j].float().cpu().numpy() for s in steps])}
        inputs = {"config": cell.config, "seed": port_seed,
                  "tokens": np.concatenate([prompts[rid].astype(np.int64), served[:max_new - 1]]),
                  "rows": [plen - 1 + i for i in range(max_new)]}
        out.append(Sample(rid, inputs, got))
    return out + _stage_samples(window)


def _stage_samples(window: _Window) -> list[Sample]:
    """One sample a kept request of the window's first batch: its
    query, cache rows and output at each ``decode_attention`` call of
    the stage step, stacked over the calls."""
    import torch

    calls, window.stage = window.stage, []
    if not calls or len(window.batches) <= WARM_BATCHES:
        return []
    b = window.batches[WARM_BATCHES]
    out = []
    for j, row in enumerate(window.keep_rows[b.index]):
        inputs = {"stage": "decode_attention", "step": window.stage_step,
                  **{k: torch.stack([c[k][j] for c in calls]) for k in ("q", "k", "v")}}
        got = {"attention": torch.stack([c["out"][j] for c in calls]).float().cpu().numpy()}
        out.append(Sample(b.rids[row], inputs, got))
    return out
