"""Serving entry point (port of ``repro.launch.serve``): batched greedy decoding
with a static-slot batch engine.

A deliberately simple continuous-batching-lite design: a fixed pool of
decode slots; finished sequences (EOS or max length) are retired and their
slots refilled from the request queue between decode steps.

Prefill is ONE forward per admission batch (``model.prefill_cache``):
pending requests accumulate in a queue and are admitted together whenever
slots free up, padded to pow2 (rows, prompt-len) buckets (the JAX package's
jit-cache buckets; here they keep the shapes, and so the results, of the
reference). The other families (the vlm, ssm and hybrid ones) prefill each
request by decode steps on its own slot. Steps run eagerly on the engine's
device, the card unless the caller names the CPU.

Usage:
  python -m repro_torch.launch.serve --arch stablelm_1_6b --smoke --device cpu \
      --requests 8 --slots 4 --max-new 16
  python -m repro_torch.launch.serve --arch mamba2_2_7b --smoke --device cpu
  python -m repro_torch.launch.serve --arch minitron_8b --max-len 1024   # on the card
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.obs import ledger as _ledger
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def _pow2_at_least(n: int, cap: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return min(p, cap)


class DecodeEngine:
    """Static-slot batched greedy decoder with batched prefill.

    Requests enter via :meth:`submit` (a pending queue); :meth:`refill`
    admits as many as there are free slots in ONE ``prefill_cache`` call,
    padded to pow2 (rows, prompt-len) buckets — pad rows replicate the
    last real request so duplicate cache scatters write identical values.

    Every request is measured through its lifecycle (submit -> admit ->
    finish): per-phase latencies land in the ``serve.queue_us`` /
    ``serve.prefill_us`` / ``serve.decode_us`` / ``serve.latency_us``
    histograms, the pending-queue depth in the ``serve.queue_depth``
    gauge+histogram (sampled at each refill), finished requests in
    :attr:`request_log` and as ``serve.request`` ledger records, under the
    JAX package's names and fields. A batched prefill is one call for n
    requests, so its wall time is attributed to each admitted request as
    the per-request share (total / n). Each refill and step ends by reading
    the greedy tokens on the host, which waits for the device.

    The cache is the JAX engine's (``model.init_cache(slots, max_len)``:
    bf16 k/v, bf16 conv windows, float32 SSM state) on ``device``; the
    engine reads and writes whatever :attr:`cache` holds, so a caller may
    put another of the same shape there. With ``record_logits``,
    :attr:`logits_log` maps each request id to the logits rows the engine
    computed for it, in order (every prompt position when prefilled by
    decode, the last one from a batched prefill, then one a step).
    """

    def __init__(self, model, params, slots: int, max_len: int, device: DeviceLike = None,
                 record_logits: bool = False):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.cache = model.init_cache(slots, max_len, device=self.device)
        self.tokens = np.zeros((slots,), np.int32)
        self.pos = np.zeros((slots,), np.int32)
        self.active = np.zeros((slots,), bool)
        self.outputs: List[Optional[list]] = [None] * slots
        self.request_ids = [-1] * slots
        self.pending: List[Tuple[int, np.ndarray]] = []
        self.prefill_calls = 0
        self.request_log: List[dict] = []   # finished-request telemetry
        self._req_meta: dict = {}           # rid -> in-flight timestamps
        self._step = model.decode_step
        self._prefill = model.prefill_cache
        self.logits_log: Optional[dict] = {} if record_logits else None
        self._slot_rows: dict = {}  # slot -> logits rows of its prefill (record_logits)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    # -- admission ---------------------------------------------------------

    def submit(self, rid: int, prompt: np.ndarray) -> None:
        """Queue a request; admitted at the next :meth:`refill`."""
        self.pending.append((rid, np.asarray(prompt, np.int32)))
        self._req_meta[rid] = {"t_submit": time.perf_counter_ns()}
        _metrics.inc("serve.requests")

    def refill(self) -> int:
        """Admit pending requests into free slots (one batched prefill).

        Returns the number of requests admitted."""
        depth = len(self.pending)
        _metrics.set_gauge("serve.queue_depth", depth)
        _metrics.observe("serve.queue_depth", depth)
        free = np.where(~self.active)[0]
        n = min(len(free), depth)
        if n == 0:
            return 0
        batch, self.pending = self.pending[:n], self.pending[n:]
        slots = free[:n]
        t0 = time.perf_counter_ns()
        with _trace.span("serve.refill", admitted=n):
            if self.model.supports_prefill_cache():
                first = self._prefill_batched(batch, slots)
            else:
                first = [self._prefill_by_decode(prompt, int(s))
                         for (_, prompt), s in zip(batch, slots)]
        t_admit = time.perf_counter_ns()
        prefill_share_us = (t_admit - t0) / 1e3 / n
        for (rid, prompt), s, tok in zip(batch, slots, first):
            s = int(s)
            self.active[s] = True
            self.request_ids[s] = rid
            self.tokens[s] = tok
            self.pos[s] = len(prompt)
            self.outputs[s] = [tok]
            if self.logits_log is not None:
                self.logits_log[rid] = self._slot_rows.pop(s)
            meta = self._req_meta.get(rid)
            if meta is not None:
                meta["t_admit"] = t_admit
                meta["queue_us"] = (t0 - meta["t_submit"]) / 1e3
                meta["prefill_us"] = prefill_share_us
                _metrics.observe("serve.queue_us", meta["queue_us"])
                _metrics.observe("serve.prefill_us", prefill_share_us)
        return n

    def _prefill_batched(self, batch, slots) -> List[int]:
        """ONE forward primes the cache for every admitted request.

        Rows and prompt length are padded to pow2 buckets; pad rows
        duplicate the last real request (identical scatter values make the
        duplicate slot indices well-defined)."""
        lens = [len(p) for _, p in batch]
        R = _pow2_at_least(len(batch), self.slots)
        P = _pow2_at_least(max(lens), self.max_len)
        tokens = np.zeros((R, P), np.int32)
        for i, (_, prompt) in enumerate(batch):
            tokens[i, :len(prompt)] = prompt
        lengths = np.asarray(lens + [lens[-1]] * (R - len(batch)), np.int32)
        srows = np.asarray(list(slots) + [slots[-1]] * (R - len(batch)), np.int32)
        tokens[len(batch):] = tokens[len(batch) - 1]
        logits, self.cache = self._prefill(self.params, self.cache, self._dev(tokens),
                                           self._dev(srows), self._dev(lengths))
        self.prefill_calls += 1
        if self.logits_log is not None:
            for i, s in enumerate(slots):
                self._slot_rows[int(s)] = [logits[i]]
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        return [int(t) for t in nxt[:len(batch)]]

    def _prefill_by_decode(self, prompt: np.ndarray, s: int) -> int:
        """Prefill of the families without :meth:`prefill_cache`: the prompt
        stepped token by token through the decode path, on slot ``s`` alone.

        The recurrent ``conv``/``ssm`` state is not positional: it carries
        whatever was stepped into it. So the slot's state is zeroed first
        (a reused slot would start from the last request's), and each step
        runs on views ``[:, s:s+1]`` of every cache leaf, which leaves every
        other slot's state where it was. Each request then starts from the
        state the single-request decode chain gives it."""
        self.prefill_calls += 1
        view = {name: t[:, s:s + 1] for name, t in self.cache.items()}
        for name in ("conv", "ssm"):
            if name in view:
                view[name].zero_()
        tokens = self._dev(np.asarray(prompt, np.int32))
        positions = torch.arange(len(prompt), dtype=torch.int32, device=self.device)
        rows = []
        for i in range(len(prompt)):
            logits, _ = self._step(self.params, view, tokens[i:i + 1], positions[i:i + 1])
            rows.append(logits[0])
        if self.logits_log is not None:
            self._slot_rows[s] = rows
        return int(torch.argmax(rows[-1]).item())

    # -- decode ------------------------------------------------------------

    def step(self, max_new: int, eos: int = -1):
        """One decode step for every active slot; retire finished ones."""
        if not self.active.any():
            return []
        logits, self.cache = self._step(self.params, self.cache,
                                        self._dev(self.tokens), self._dev(self.pos))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        finished = []
        for s in range(self.slots):
            if not self.active[s]:
                continue
            self.outputs[s].append(int(nxt[s]))
            if self.logits_log is not None:
                self.logits_log[self.request_ids[s]].append(logits[s])
            self.tokens[s] = nxt[s]
            self.pos[s] += 1
            done = (len(self.outputs[s]) >= max_new or int(nxt[s]) == eos
                    or int(self.pos[s]) >= self.max_len - 1)
            if done:
                finished.append((self.request_ids[s], self.outputs[s]))
                self.active[s] = False
                self._finish(self.request_ids[s], len(self.outputs[s]))
        return finished

    def _finish(self, rid: int, ntokens: int) -> None:
        """Close a request's telemetry span: per-phase latencies into the
        serve histograms, the request_log, and the decision ledger."""
        _metrics.inc("serve.tokens", ntokens)
        meta = self._req_meta.pop(rid, None)
        if meta is None or "t_admit" not in meta:
            return
        now = time.perf_counter_ns()
        decode_us = (now - meta["t_admit"]) / 1e3
        total_us = (now - meta["t_submit"]) / 1e3
        _metrics.observe("serve.decode_us", decode_us)
        _metrics.observe("serve.latency_us", total_us)
        entry = {"rid": rid, "queue_us": meta["queue_us"],
                 "prefill_us": meta["prefill_us"], "decode_us": decode_us,
                 "total_us": total_us, "tokens": ntokens}
        self.request_log.append(entry)
        if _ledger.enabled():
            _ledger.record("serve.request", **entry)


def serve(engine: DecodeEngine, requests, max_new: int, eos: int = -1):
    """Run the engine to completion over ``requests`` [(rid, prompt), ...].

    Returns (done, steps): done is [(rid, output_tokens), ...]."""
    for rid, prompt in requests:
        engine.submit(rid, prompt)
    done, steps = [], 0
    while engine.pending or engine.active.any():
        engine.refill()
        done += engine.step(max_new, eos=eos)
        steps += 1
    return done, steps


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the model runs (default: the card)")
    args = p.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only ({cfg.family}): it has no decode "
                         "cache to serve from")
    model = build_model(cfg)
    dev = resolve_device(args.device)
    params = model.init(args.seed, device=dev)
    engine = DecodeEngine(model, params, args.slots, args.max_len, device=dev)

    rng = np.random.default_rng(args.seed)
    requests = [
        (i, rng.integers(0, cfg.vocab, (args.prompt_len,)).astype(np.int32))
        for i in range(args.requests)]
    t0 = time.perf_counter()
    done, steps = serve(engine, requests, args.max_new)
    dt = time.perf_counter() - t0
    ntok = sum(len(o) for _, o in done)
    mode = "batched" if model.supports_prefill_cache() else "by-decode"
    print(f"served {len(done)} requests, {ntok} tokens in {dt:.2f}s "
          f"({ntok / dt:.1f} tok/s, {steps} engine steps, "
          f"{engine.prefill_calls} {mode} prefills) on {dev}")
    show = len(done) if args.smoke else 4
    for rid, out in sorted(done)[:show]:
        print(f"  req {rid}: {out[:10]}{'...' if len(out) > 10 else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
