"""The port's serving engine (``repro_torch.launch.serve``) on the CPU against
the JAX package's: the slice as a whole.

The same float32 weights (JAX's initialisation carried across with
``weights.params_from_numpy``) and the same ragged requests go through both
``DecodeEngine``s; the greedy outputs must be identical (float32 pins them,
as ``tests/test_serve.py::_f32_model`` does). Within the port, the batched
prefill must equal prefill-by-decode and the per-request reference. The
telemetry keeps JAX's names and fields, and the CLI runs in-process.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import jax

import repro.configs as jconfigs
import repro.launch.serve as jserve
from repro.models import build_model as jbuild
from repro.obs import ledger as jledger
from repro.obs import metrics as jmetrics
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import weights
from repro_torch.obs import ledger as tledger
from repro_torch.obs import metrics as tmetrics
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

DEV = "cpu"
SERVE_METRICS = ["serve.requests", "serve.tokens", "serve.latency_us", "serve.queue_us",
                 "serve.prefill_us", "serve.decode_us", "serve.queue_depth"]
# serve.* names that other tests in the process may have set (LinearSparse's
# retune counters); reset with the engine's, as tests/test_serve.py does
OTHER_SERVE_METRICS = ["serve.retune", "serve.format_switch"]
# 7 ragged requests (lengths 3-11) through 3 slots: pow2 prompt-length and
# row padding, refills between steps, duplicate-slot pad rows
LENGTHS = (3, 11, 5, 7, 4, 9, 6)
MAX_NEW, MAX_LEN, SLOTS = 6, 32, 3


def _requests(vocab, lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, (n,)).astype(np.int32)) for i, n in enumerate(lengths)]


@pytest.fixture(scope="module", params=["stablelm_1_6b", "minitron_8b"])
def served(request):
    """Both engines over the same weights and requests (f32), JAX's outputs
    computed once per architecture."""
    arch = request.param
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True), dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = weights.params_from_numpy(jax.tree.map(np.asarray, jp), DEV)
    reqs = _requests(tcfg.vocab)
    jdone, jsteps = jserve.serve(jserve.DecodeEngine(jm, jp, SLOTS, MAX_LEN), reqs, MAX_NEW)
    return dict(arch=arch, jm=jm, jp=jp, tm=build_model(tcfg), tp=tp, cfg=tcfg, reqs=reqs,
                jdone=dict(jdone), jsteps=jsteps)


def _ref_greedy(model, params, prompt, max_new, max_len):
    """Single-request greedy decode with per-token prefill-by-decode (the
    port's copy of ``tests/test_serve.py::_ref_greedy``)."""
    cache = model.init_cache(1, max_len, device=DEV)
    logits = None
    for i, t in enumerate(prompt):
        logits, cache = model.decode_step(params, cache, torch.tensor([t]), torch.tensor([i]))
    tok = int(torch.argmax(logits[0]))
    out, pos = [tok], len(prompt)
    while len(out) < max_new:
        logits, cache = model.decode_step(params, cache, torch.tensor([tok]),
                                          torch.tensor([pos]))
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        pos += 1
    return out


def test_pow2_bucket_matches():
    cases = [(n, cap) for cap in (1, 4, 8, 64) for n in range(1, 70)]
    assert [tserve._pow2_at_least(n, c) for n, c in cases] == \
        [jserve._pow2_at_least(n, c) for n, c in cases]


def test_engine_matches_jax_engine(served):
    """The slice as a whole: identical greedy outputs, same step count."""
    engine = tserve.DecodeEngine(served["tm"], served["tp"], SLOTS, MAX_LEN, device=DEV)
    done, steps = tserve.serve(engine, served["reqs"], MAX_NEW)
    assert dict(done) == served["jdone"]
    assert steps == served["jsteps"]
    assert all(len(o) == MAX_NEW for o in dict(done).values())
    assert engine.prefill_calls >= 3  # 7 requests through 3 slots


def test_batched_prefill_matches_per_token_decode(served):
    """The port's own claim, as JAX's test makes it: every request's batched
    output equals its single-request per-token reference."""
    engine = tserve.DecodeEngine(served["tm"], served["tp"], SLOTS, MAX_LEN, device=DEV)
    done, _ = tserve.serve(engine, served["reqs"], MAX_NEW)
    got = dict(done)
    for rid, prompt in served["reqs"]:
        ref = _ref_greedy(served["tm"], served["tp"], prompt, MAX_NEW, MAX_LEN)
        assert got[rid] == ref, f"request {rid} diverged"


def test_prefill_by_decode_path_matches_batched(served, monkeypatch):
    """The fallback path of families without ``prefill_cache``, forced on
    the dense model: same outputs, one prefill call per request."""
    monkeypatch.setattr(type(served["tm"]), "supports_prefill_cache", lambda self: False)
    engine = tserve.DecodeEngine(served["tm"], served["tp"], SLOTS, MAX_LEN, device=DEV)
    done, _ = tserve.serve(engine, served["reqs"], MAX_NEW)
    assert dict(done) == served["jdone"]
    assert engine.prefill_calls == len(LENGTHS)


def test_engine_float32_cache_and_eos(served):
    """A float32 cache serves the same tokens here; EOS retires requests as
    JAX's engine retires them (checked from the first decode step on: the
    prefill's token is not)."""
    engine = tserve.DecodeEngine(served["tm"], served["tp"], SLOTS, MAX_LEN, device=DEV)
    assert engine.cache["k"].dtype == torch.bfloat16  # the JAX engine's cache
    engine.cache = served["tm"].init_cache(SLOTS, MAX_LEN, torch.float32, device=DEV)
    done, _ = tserve.serve(engine, served["reqs"], MAX_NEW)
    assert dict(done) == served["jdone"]
    eos = served["jdone"][0][2]
    jdone, _ = jserve.serve(jserve.DecodeEngine(served["jm"], served["jp"], SLOTS, MAX_LEN),
                            served["reqs"], MAX_NEW, eos=eos)
    tdone, _ = tserve.serve(tserve.DecodeEngine(served["tm"], served["tp"], SLOTS, MAX_LEN,
                                                device=DEV), served["reqs"], MAX_NEW, eos=eos)
    assert dict(tdone) == dict(jdone)
    out = dict(tdone)[0]
    assert out[-1] == eos and len(out) <= 3


def test_max_len_retires_requests(served):
    """A request retires when its next write position reaches max_len - 1."""
    reqs = served["reqs"][:2]
    max_len = 16
    jdone, _ = jserve.serve(jserve.DecodeEngine(served["jm"], served["jp"], 2, max_len),
                            reqs, 40)
    tdone, _ = tserve.serve(tserve.DecodeEngine(served["tm"], served["tp"], 2, max_len,
                                                device=DEV), reqs, 40)
    assert dict(tdone) == dict(jdone)
    assert [len(dict(tdone)[r]) for r, _ in reqs] == [max_len - len(p) for _, p in reqs]


def _run_with_telemetry(serve_mod, metrics, ledger, engine, reqs):
    ledger.set_enabled(True)
    ledger.clear()
    metrics.reset(SERVE_METRICS + OTHER_SERVE_METRICS)
    done, _ = serve_mod.serve(engine, reqs, 3)
    snap = metrics.snapshot()
    recs = ledger.records(kind="serve.request")
    ledger.clear()
    return done, snap, recs


def test_telemetry_names_and_fields_match_jax(served):
    reqs = _requests(served["cfg"].vocab, (4, 4, 4, 4, 4))
    jeng = jserve.DecodeEngine(served["jm"], served["jp"], 2, MAX_LEN)
    teng = tserve.DecodeEngine(served["tm"], served["tp"], 2, MAX_LEN, device=DEV)
    jdone, jsnap, jrecs = _run_with_telemetry(jserve, jmetrics, jledger, jeng, reqs)
    tdone, tsnap, trecs = _run_with_telemetry(tserve, tmetrics, tledger, teng, reqs)
    assert dict(tdone) == dict(jdone)
    for kind in ("counters", "gauges", "histograms"):
        jn = {n for n in jsnap[kind] if n.startswith("serve.")}
        tn = {n for n in tsnap[kind] if n.startswith("serve.")}
        assert tn == jn, kind
    for name in ("serve.requests", "serve.tokens"):
        assert tsnap["counters"][name] == jsnap["counters"][name]
    for name in SERVE_METRICS[2:]:
        assert tsnap["histograms"][name]["count"] == jsnap["histograms"][name]["count"], name
        assert set(tsnap["histograms"][name]) == set(jsnap["histograms"][name])
    assert tsnap["gauges"]["serve.queue_depth"] == jsnap["gauges"]["serve.queue_depth"]
    assert [sorted(r) for r in trecs] == [sorted(r) for r in jrecs]
    assert sorted(r["rid"] for r in trecs) == list(range(5))
    assert [sorted(e) for e in teng.request_log] == [sorted(e) for e in jeng.request_log]
    for e in teng.request_log:
        assert e["tokens"] == 3 and e["prefill_us"] > 0 and e["decode_us"] > 0
        assert e["total_us"] >= e["queue_us"] + e["decode_us"]


def test_refill_is_a_span(served):
    from repro_torch.obs import trace
    with trace.tracing("full"):
        trace.clear()
        engine = tserve.DecodeEngine(served["tm"], served["tp"], 2, MAX_LEN, device=DEV)
        tserve.serve(engine, served["reqs"][:3], 2)
        spans = [e for e in trace.events() if e["name"] == "serve.refill"]
        trace.clear()
    assert [s["args"]["admitted"] for s in spans] == [2, 1]


def test_cli_serves_in_process():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tserve.main(["--arch", "stablelm_1_6b", "--smoke", "--device", "cpu",
                          "--requests", "6", "--slots", "3", "--prompt-len", "5",
                          "--max-new", "4"])
    text = out.getvalue()
    assert rc == 0
    assert "served 6 requests, 24 tokens" in text and "batched prefills" in text, text
    for rid in range(6):
        assert f"req {rid}:" in text, text


def test_cli_defaults_to_the_card_and_refuses_encoders():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "minitron_8b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m = build_model(tconfigs.get_config("minitron_8b", smoke=True))
        tserve.DecodeEngine(m, m.init(0, device=DEV), 2, 8)
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # the recurrent families serve now
        assert tserve.main(["--arch", "mamba2_2_7b", "--smoke", "--device", "cpu",
                            "--requests", "3", "--slots", "2", "--max-new", "2"]) == 0
    assert "served 3 requests, 6 tokens" in out.getvalue()
    assert "3 by-decode prefills" in out.getvalue()
