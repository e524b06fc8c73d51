"""The port's resilience plane (keto_tpu_torch/resilience.py and the
batcher's overload and failure routes) held against keto_tpu's on the
same inputs: deadline ingestion, the circuit breaker's states on an
injected clock, admission, and both packages' CheckBatchers on the same
gated, raising or stalling stub engines, with equal answers, equal
typed errors and equal counts of what each sheds or expires. On a
failing or stalled device the breaker moves as keto_tpu's and the
failures count the same, but where keto_tpu answers from its host oracle
the port fails the riders typed (500, or 503 while the breaker is open).

Every wait is bounded by an explicit timeout. Tolerance: exact equality;
budgets are compared to 1e-9 s.
"""

import threading
import time

import pytest

from keto_tpu import resilience as jres
from keto_tpu.api.batcher import CheckBatcher as JBatcher
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.definitions import RESULT_IS_MEMBER as J_MEMBER
from keto_tpu.errors import KetoError as JKetoError
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.observability import Metrics, RequestTrace as JTrace
from keto_tpu.registry import Registry as JRegistry

from keto_tpu_torch import resilience as tres
from keto_tpu_torch.api.batcher import CheckBatcher as TBatcher
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine.definitions import RESULT_IS_MEMBER as T_MEMBER
from keto_tpu_torch.errors import KetoError as TKetoError
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.resilience import ServeCounters

WAIT_S = 10


def wait_until(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.002)
    return cond()


# -- deadlines ------------------------------------------------------------------


def test_deadline_budget_and_expiry():
    for mod in (jres, tres):
        dl = mod.Deadline.after_ms(50)
        assert not dl.expired() and 0 < dl.remaining_s() <= 0.05
    time.sleep(0.06)
    for mod in (jres, tres):
        dl = mod.Deadline(0.0)
        assert dl.expired() and dl.remaining_s() == 0.0


@pytest.mark.parametrize("value", [None, "", "250", "0.5", "soon", "-5", "0"])
def test_parse_timeout_ms_as_keto_tpu(value):
    def run(mod):
        try:
            return ("ok", mod.parse_timeout_ms(value))
        except (JKetoError, TKetoError) as e:
            return ("err", e.status, e.to_dict())

    assert run(tres) == run(jres)


SERVE_CHECK = {"default_deadline_ms": 1000, "max_deadline_ms": 2000}
INGEST_CASES = {
    "header_wins": (SERVE_CHECK, {"request_ms": 100}),
    "native_when_no_header": (SERVE_CHECK, {"native_s": 0.5}),
    "header_over_native": (SERVE_CHECK, {"request_ms": 300, "native_s": 0.5}),
    "default": (SERVE_CHECK, {}),
    "clamped": (SERVE_CHECK, {"request_ms": 60000}),
    "no_config": ({}, {}),
    "sentinel_native": ({}, {"native_s": 1e15}),
    "expired_native": ({}, {"native_s": -0.01}),
    "day_cap": ({}, {"request_ms": 1e12}),
}


@pytest.mark.parametrize("case", sorted(INGEST_CASES))
def test_ingest_deadline_precedence_and_clamp(case):
    serve_check, kw = INGEST_CASES[case]
    cfg = {"serve": {"check": serve_check}} if serve_check else {}
    # both configs first: keto_tpu's first schema validation takes seconds
    tcfg, jcfg = TConfig(cfg), JConfig(cfg)
    got = tres.ingest_deadline(tcfg, **kw)
    want = jres.ingest_deadline(jcfg, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.budget_s == pytest.approx(want.budget_s, abs=1e-9)
        assert got.expired() == want.expired()


@pytest.mark.parametrize("hint", [None, 0, 0.05, 1.0, 3.2, 60.0])
def test_retry_after_header_value(hint):
    assert tres.retry_after_header_value(hint) == jres.retry_after_header_value(hint)


# -- the circuit breaker ----------------------------------------------------------

# each step: ("allow" | "success" | "failure" | "trip" | "trip1" | "clock", value)
BREAKER_CASES = {
    "full_cycle": (2, 5.0, ["allow", "failure", "failure", "allow", ("clock", 5.1), "allow",
                            "allow", "success"]),
    "half_open_failure_reopens": (1, 2.0, ["failure", ("clock", 2.1), "allow", "failure",
                                           "allow", ("clock", 4.2), "allow"]),
    "lost_probe_reclaimed": (1, 2.0, ["failure", ("clock", 2.1), "allow", "allow",
                                      ("clock", 4.2), "allow", "success"]),
    "success_resets_streak": (2, 5.0, ["failure", "success", "failure", "allow"]),
    "trip_holds_against_inflight": (5, 5.0, ["trip", "success", "allow", ("clock", 5.1),
                                             "allow", "success"]),
    "trip_custom_cooldown": (5, 5.0, ["trip1", ("clock", 0.5), "allow", ("clock", 1.1),
                                      "allow"]),
}


def _drive_breaker(cls, threshold, cooldown, steps):
    clock = [0.0]
    br = cls(threshold=threshold, cooldown_s=cooldown, clock=lambda: clock[0])
    trail = []
    for step in steps:
        if isinstance(step, tuple):
            clock[0] = step[1]
            got = None
        elif step == "allow":
            got = br.allow()
        elif step == "success":
            got = br.record_success()
        elif step == "failure":
            got = br.record_failure()
        elif step == "trip":
            got = br.trip()
        else:
            got = br.trip(cooldown_s=1.0)
        trail.append((step, got, br.state, br.open_remaining_s()))
    return trail, list(br.transitions)


@pytest.mark.parametrize("case", sorted(BREAKER_CASES))
def test_breaker_cycle_as_keto_tpu(case):
    threshold, cooldown, steps = BREAKER_CASES[case]
    got = _drive_breaker(tres.CircuitBreaker, threshold, cooldown, steps)
    want = _drive_breaker(jres.CircuitBreaker, threshold, cooldown, steps)
    assert got == want
    if case == "full_cycle":
        assert got[1] == ["open", "half_open", "closed"]


# -- batchers on stub engines -------------------------------------------------------


class _GatedEngine:
    """check_batch blocks on a gate and records every batch."""

    def __init__(self, member):
        self.member = member
        self.gate = threading.Event()
        self.batches = []
        self.lock = threading.Lock()

    def check_batch(self, tuples, max_depth=0):
        with self.lock:
            self.batches.append([str(t) for t in tuples])
        assert self.gate.wait(timeout=WAIT_S)
        return [self.member for _ in tuples]


class _FailingDeviceEngine:
    """A split-phase engine whose device path raises; its host surface
    (keto_tpu's batcher asks it, the port's never does) answers."""

    def __init__(self, member, stall_s=0.0, healthy=False):
        self.member = member
        self.stall_s = stall_s
        self.healthy = healthy
        self.submits = 0
        self.host_batches = 0

    def check_batch_submit(self, tuples, depth=0):
        self.submits += 1
        if self.stall_s:
            time.sleep(self.stall_s)
        elif not self.healthy:
            raise RuntimeError("device wedge")
        return list(tuples)

    def check_batch_resolve(self, handle):
        return [self.member for _ in handle]

    def check_batch_host(self, tuples, depth=0):
        self.host_batches += 1
        return [self.member for _ in tuples]


class Side:
    """One package's batcher, errors, trace and counters."""

    def __init__(self, pkg):
        self.pkg = pkg
        if pkg == "keto_tpu":
            self.member, self.tuple = J_MEMBER, JTuple.from_string
            self.Batcher, self.Trace, self.Deadline = JBatcher, JTrace, jres.Deadline
            self.Breaker, self.metrics = jres.CircuitBreaker, Metrics()
        else:
            self.member, self.tuple = T_MEMBER, TTuple.from_string
            self.Batcher, self.Trace, self.Deadline = TBatcher, tres.RequestTrace, tres.Deadline
            self.Breaker, self.counters = tres.CircuitBreaker, ServeCounters()

    def batcher(self, engine, **kw):
        if self.pkg == "keto_tpu":
            return self.Batcher(engine, metrics=self.metrics, **kw)
        return self.Batcher(engine, counters=self.counters, **kw)

    def counts(self) -> dict:
        """The counters in the port's shape."""
        if self.pkg == "port":
            return self.counters.snapshot()
        m = self.metrics

        def v(c):
            return int(c._value.get())

        return {
            "coalesced": v(m.check_coalesced_total),
            "shed": {k: v(m.requests_shed_total.labels(k)) for k in ("queue_full", "draining")},
            "deadline_exceeded": {k: v(m.deadline_exceeded_total.labels(k))
                                  for k in ("admission", "wait", "queue")},
            "check_batch_failed": {k: v(m.check_batch_failed_total.labels(k))
                                   for k in ("device", "device_timeout", "engine", "keto")},
        }


def _error(fn):
    try:
        return ("ok", fn())
    except (JKetoError, TKetoError) as e:
        return (type(e).__name__, e.status, e.to_dict(), getattr(e, "retry_after_s", None))


def _outcome(side, fn):
    """("ok", the answer is a member), or the typed error's class, status
    and whether it carries a retry hint."""
    try:
        return ("ok", fn() is side.member)
    except (JKetoError, TKetoError) as e:
        return (type(e).__name__, e.status, getattr(e, "retry_after_s", None) is not None)


def _comparable(counts):
    """The counts keto_tpu exports as metrics (batches and batched checks
    are stage timings there; shed "breaker_open" is the port's own)."""
    out = {k: v for k, v in counts.items() if k not in ("batches", "batched_checks")}
    out["shed"] = {k: v for k, v in out["shed"].items() if k != "breaker_open"}
    return out


def run_admission_bound(side):
    eng = _GatedEngine(side.member)
    b = side.batcher(eng, window_s=0.0, max_queue=1)
    try:
        res = {}
        th = threading.Thread(target=lambda: res.update(ok=b.check(side.tuple("files:x#owner@u"))),
                              daemon=True)
        th.start()
        assert wait_until(lambda: b._pending == 1)
        # the bound holds at admit() and at enqueue
        admit = _error(b.admit)
        shed = _error(lambda: b.check(side.tuple("files:y#owner@u")))
        eng.gate.set()
        th.join(timeout=WAIT_S)
        assert res["ok"] is side.member
        # the slot is back: admission opens again
        reopened = _error(b.admit)
        return admit, shed, reopened, side.counts()
    finally:
        eng.gate.set()
        b.close()


def run_caller_fails_fast(side):
    eng = _GatedEngine(side.member)
    b = side.batcher(eng, window_s=0.0)
    try:
        rt = side.Trace(deadline=side.Deadline(0.08))
        t0 = time.perf_counter()
        got = _error(lambda: b.check(side.tuple("files:x#owner@u"), rt=rt))
        assert time.perf_counter() - t0 < 2 * 0.08 + 0.25  # about the budget
        return got, side.counts()
    finally:
        eng.gate.set()
        b.close()


def run_expired_rider(side):
    eng = _GatedEngine(side.member)
    eng.gate.set()
    b = side.batcher(eng, window_s=0.05)
    try:
        rt = side.Trace(deadline=side.Deadline(0.001))
        time.sleep(0.01)  # expired while "queued"
        got = _error(lambda: b.check(side.tuple("files:x#owner@u"), rt=rt))
        time.sleep(0.2)  # the collector drops it at the launch boundary
        return got, eng.batches, side.counts()
    finally:
        b.close()


def run_breaker_trips(side):
    eng = _FailingDeviceEngine(side.member)
    br = side.Breaker(threshold=2, cooldown_s=60.0)
    b = side.batcher(eng, window_s=0.0, breaker=br)
    try:
        # failures 1 and 2: the device raises, the breaker opens on the
        # second
        check = lambda: b.check(side.tuple("files:x#owner@u"))  # noqa: E731
        answers = [_outcome(side, check) for _ in range(2)]
        assert wait_until(lambda: br.state == "open")
        at_open = eng.submits
        # open: the device left alone
        answers += [_outcome(side, check) for _ in range(3)]
        return answers, eng.submits - at_open, eng.host_batches, list(br.transitions), \
            side.counts()
    finally:
        b.close()


def run_half_open_probe(side):
    clock = [0.0]
    eng = _FailingDeviceEngine(side.member)
    br = side.Breaker(threshold=1, cooldown_s=1.0, clock=lambda: clock[0])
    b = side.batcher(eng, window_s=0.0, breaker=br)
    try:
        check = lambda: b.check(side.tuple("files:x#owner@u"))  # noqa: E731
        first = _outcome(side, check)  # trips
        assert wait_until(lambda: br.state == "open")
        eng.healthy = True
        clock[0] = 1.1  # the next group is the probe
        probe = _outcome(side, check)
        assert wait_until(lambda: br.state == "closed")
        return first, probe, list(br.transitions), side.counts()
    finally:
        b.close()


def run_launch_watchdog(side):
    eng = _FailingDeviceEngine(side.member, stall_s=0.8)
    br = side.Breaker(threshold=100)
    b = side.batcher(eng, window_s=0.0, device_timeout_ms=80, breaker=br)
    try:
        t0 = time.perf_counter()
        res = _outcome(side, lambda: b.check(side.tuple("files:x#owner@u")))
        elapsed = time.perf_counter() - t0
        # the abandoned launch released its in-flight slot; the next group
        # waits on the wedged launch thread until the routing watchdog
        t1 = time.perf_counter()
        second = _outcome(side, lambda: b.check(side.tuple("files:y#owner@u")))
        elapsed_2 = time.perf_counter() - t1
        time.sleep(0.9)  # the stalled submits retire
        return res, elapsed < 0.6, second, elapsed_2 < 0.6, eng.host_batches, side.counts()
    finally:
        b.close()


def run_engine_error(side):
    class Boom:
        def check_batch(self, tuples, depth):
            raise ValueError("bad graph row")

    b = side.batcher(Boom(), window_s=0.0)
    try:
        got = _error(lambda: b.check(side.tuple("files:x#owner@u")))
        try:
            b.check(side.tuple("files:x#owner@u"))
        except RuntimeError as e:  # still a RuntimeError for callers
            runtime = "bad graph row" in str(e)
        return got, runtime, side.counts()
    finally:
        b.close()


BATCHER_CASES = {
    "admission_bound_is_atomic": run_admission_bound,
    "caller_fails_fast_on_gated_engine": run_caller_fails_fast,
    "expired_rider_never_occupies_a_slot": run_expired_rider,
    "raw_engine_error_becomes_typed": run_engine_error,
}


@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_batcher_resilience_as_keto_tpu(case):
    """TestBatcherAdmission, TestBatcherDeadline and
    TestEngineErrorClassification of tests/test_resilience.py, on both
    packages' batchers."""
    got = BATCHER_CASES[case](Side("port"))
    want = BATCHER_CASES[case](Side("keto_tpu"))
    *got_rest, got_counts = got
    *want_rest, want_counts = want
    assert got_rest == want_rest
    assert _comparable(got_counts) == want_counts
    if case == "admission_bound_is_atomic":
        admit, shed, reopened = got_rest
        assert admit[1] == shed[1] == 429 and shed[3] > 0 and reopened == ("ok", None)
        assert got_counts["shed"]["queue_full"] == 2
    if case == "caller_fails_fast_on_gated_engine":
        assert got_rest[0][1] == 504 and got_counts["deadline_exceeded"]["wait"] == 1
    if case == "expired_rider_never_occupies_a_slot":
        assert got_rest[1] == [] and got_counts["batches"] == 0


DEVICE_FAILURE_CASES = {
    "device_failures_fail_typed_then_trip": run_breaker_trips,
    "half_open_probe_closes_on_success": run_half_open_probe,
    "stalled_launch_fails_typed": run_launch_watchdog,
}

FAILED = ("CheckBatchFailedError", 500, False)
OPEN = ("StoreUnavailableError", 503, True)


@pytest.mark.parametrize("case", sorted(DEVICE_FAILURE_CASES))
def test_batcher_device_failure_as_keto_tpu_but_typed(case):
    """TestBreakerInBatcher and TestLaunchWatchdog of
    tests/test_resilience.py on both packages' batchers: the breaker's
    transitions, the device's submits and the failure counts equal, but
    where keto_tpu answers a failed or stalled batch from its host oracle
    the port fails its riders typed and never asks the host."""
    got = DEVICE_FAILURE_CASES[case](Side("port"))
    want = DEVICE_FAILURE_CASES[case](Side("keto_tpu"))
    got_counts, want_counts = got[-1], want[-1]
    assert _comparable(got_counts) == want_counts
    if case == "device_failures_fail_typed_then_trip":
        answers, submits_open, host_batches, transitions, _ = got
        assert want[0] == [("ok", True)] * 5 and want[2] >= 5
        assert answers == [FAILED] * 2 + [OPEN] * 3
        assert submits_open == want[1] == 0 and host_batches == 0
        assert transitions == want[3] == ["open"]
        assert got_counts["check_batch_failed"]["device"] == 2
        assert got_counts["shed"]["breaker_open"] == 3
    if case == "half_open_probe_closes_on_success":
        first, probe, transitions, _ = got
        assert want[:2] == (("ok", True), ("ok", True))
        assert first == FAILED and probe == ("ok", True)
        assert transitions == want[2] == ["open", "half_open", "closed"]
    if case == "stalled_launch_fails_typed":
        res, fast, second, fast_2, host_batches, _ = got
        assert want[0] == ("ok", True) and want[1] and want[3] and want[4] >= 1
        assert res == second == FAILED and fast and fast_2 and host_batches == 0
        assert got_counts["check_batch_failed"]["device_timeout"] >= 1


# -- admission --------------------------------------------------------------------


def _registries():
    cfg = {"dsn": "memory", "serve": {"check": {"breaker": {"threshold": 9,
                                                            "cooldown_s": 2.5}}}}
    return TRegistry(TConfig(cfg), device="cpu"), JRegistry(JConfig(cfg))


def test_admit_check_draining_and_expired():
    treg, jreg = _registries()
    sides = ((treg, tres, tres.RequestTrace), (jreg, jres, JTrace))
    for draining in (False, True):
        outcomes = []
        for reg, mod, trace in sides:
            if draining:
                reg.draining.set()
            expired = trace(deadline=mod.Deadline(0.0))
            outcomes.append((_error(lambda: mod.admit_check(reg, None, None)),
                             _error(lambda: mod.admit_check(reg, None, expired))))
        assert outcomes[0] == outcomes[1], draining
    m = jreg.metrics()
    assert treg.counters().snapshot()["shed"]["draining"] == \
        int(m.requests_shed_total.labels("draining")._value.get()) == 2
    assert treg.counters().snapshot()["deadline_exceeded"]["admission"] == \
        int(m.deadline_exceeded_total.labels("admission")._value.get()) == 1


@pytest.mark.parametrize("n_objects", [8, 9])
def test_admit_filter_bound(n_objects):
    cfg = {"dsn": "memory", "filter": {"max_objects": 8}}
    treg, jreg = TRegistry(TConfig(cfg), device="cpu"), JRegistry(JConfig(cfg))
    assert _error(lambda: tres.admit_filter(treg, n_objects)) == \
        _error(lambda: jres.admit_filter(jreg, n_objects))


def test_registry_breaker_reads_config():
    treg, jreg = _registries()
    br, jbr = treg.circuit_breaker(), jreg.circuit_breaker()
    assert (br.threshold, br.cooldown_s) == (jbr.threshold, jbr.cooldown_s) == (9, 2.5)
    assert treg.circuit_breaker() is br
