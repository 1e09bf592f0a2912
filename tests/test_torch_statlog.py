"""Port parity: the async rolling appender and the stat loggers
(``core/statlog.py``, ``core/logs.py``) of ``sentinel_tpu_torch`` against
``sentinel_tpu``'s (``tests/test_statlog.py``).

Each scenario runs on both packages' modules, writing under a directory
of its own; the files must hold the same lines. The daemon's timing
(drain without an explicit flush, idle exit and revival) is checked on
the port with time limits, and its lines against the reference's.
"""

import time

import pytest

from sentinel_tpu.core import logs as jlogs
from sentinel_tpu.core import statlog as jstat
from sentinel_tpu.core.clock import ManualClock as JClock
from sentinel_tpu_torch.core import logs as tlogs
from sentinel_tpu_torch.core import statlog as tstat
from sentinel_tpu_torch.core.clock import ManualClock as TClock

T0 = 1_700_000_000_000
MODS = {"jax": (jstat, jlogs, JClock), "torch": (tstat, tlogs, TClock)}


def both(tmp_path, fn):
    """``fn(statlog, logs, clock_cls, dir)`` for both packages → the
    port's result, which must equal the reference's."""
    out = {}
    for name, (st, lg, clk) in MODS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = fn(st, lg, clk, d)
    assert out["torch"] == out["jax"]
    return out["torch"]


def wait_for(cond, seconds, what):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(what)


def test_appender_flush_writes_lines(tmp_path):
    def run(st, lg, clk, d):
        ap = st.AsyncRollingAppender(str(d / "a.log"), flush_interval_s=60)
        out = [ap.append("one"), ap.append_many(["two", "three"])]
        ap.flush()
        ap.close()
        return out, (d / "a.log").read_text().splitlines()

    assert both(tmp_path, run) == ([True, 2], ["one", "two", "three"])


def test_appender_daemon_flushes_without_explicit_flush(tmp_path):
    def run(st, lg, clk, d):
        p = d / "d.log"
        ap = st.AsyncRollingAppender(str(p), flush_interval_s=0.05)
        ap.append("hands-off")
        wait_for(lambda: p.exists() and "hands-off" in p.read_text(), 5,
                 "daemon never drained the queue")
        ap.close()
        return p.read_text().splitlines()

    assert both(tmp_path, run) == ["hands-off"]


def test_appender_size_rotation_keeps_backups(tmp_path):
    def run(st, lg, clk, d):
        p = d / "r.log"
        ap = st.AsyncRollingAppender(str(p), max_bytes=64, backups=2,
                                     flush_interval_s=60)
        for i in range(3):
            ap.append_many([f"chunk-{i}-{j}-{'x' * 40}" for j in range(4)])
            ap.flush()
        ap.close()
        return {f.name: f.read_text() for f in sorted(d.iterdir())}

    files = both(tmp_path, run)
    assert set(files) == {"r.log", "r.log.1", "r.log.2"}
    assert "chunk-1-" in files["r.log.1"]


def test_appender_overflow_drops_visibly(tmp_path):
    def run(st, lg, clk, d):
        ap = st.AsyncRollingAppender(str(d / "o.log"), queue_cap=4,
                                     flush_interval_s=60)
        accepted = sum(1 for i in range(10) if ap.append(f"l{i}"))
        ap.flush()
        ap.close()
        return accepted, (d / "o.log").read_text().splitlines()

    accepted, lines = both(tmp_path, run)
    assert accepted == 4
    assert lines == ["l0", "l1", "l2", "l3", "__appender_dropped__|6"]


def test_appender_idle_daemon_exits_and_revives(tmp_path):
    p = tmp_path / "i.log"
    ap = tstat.AsyncRollingAppender(str(p), flush_interval_s=0.01)
    ap.append("first")
    wait_for(lambda: ap._thread is None or not ap._thread.is_alive(), 10,
             "idle daemon never exited")
    ap.append("second")              # must revive the daemon
    wait_for(lambda: p.exists() and "second" in p.read_text(), 5,
             "daemon did not revive after idle exit")
    ap.close()
    assert ap not in tstat._all_appenders
    assert p.read_text().splitlines() == ["first", "second"]


def test_stat_logger_rolls_per_period(tmp_path):
    def run(st, lg, clk_cls, d):
        clk = clk_cls(start_ms=T0)
        sl = st.StatLogger("cluster-server", clk, base_dir=str(d))
        sl.stat("flow-1", "pass")
        sl.stat("flow-1", "pass", values=(3,))
        sl.stat("flow-2", "block")
        clk.advance_ms(1000)
        sl.stat("flow-1", "pass")
        sl.flush()
        sl.appender.close()
        return (d / "cluster-server.log").read_text().splitlines()

    lines = both(tmp_path, run)
    assert f"{T0}|flow-1,pass|4" in lines
    assert f"{T0}|flow-2,block|1" in lines
    assert f"{T0 + 1000}|flow-1,pass|1" in lines


def test_stat_logger_multi_value_and_overflow(tmp_path):
    def run(st, lg, clk_cls, d):
        sl = st.StatLogger("multi", clk_cls(start_ms=T0), base_dir=str(d),
                           max_entries=2)
        for key, vals in (("a", (1, 10)), ("a", (2, 20)), ("b", (5, 50)),
                          ("c", (9, 90))):
            sl.stat(key, values=vals)
        sl.flush()
        sl.appender.close()
        return (d / "multi.log").read_text().splitlines()

    lines = both(tmp_path, run)
    assert f"{T0}|a|3,30" in lines and f"{T0}|b|5,50" in lines
    assert f"{T0}|__dropped__|1" in lines


def test_block_log_hot_path_never_touches_disk(tmp_path):
    def run(st, lg, clk_cls, d):
        clk = clk_cls(start_ms=T0)
        log = lg.BlockStatLogger(clk, base_dir=str(d))
        log.appender._interval = 60      # the daemon stays parked
        log.log("svc", "FlowException")
        clk.advance_ms(1000)
        log.log("svc", "FlowException")  # rolls the first second out
        before = (d / lg.BlockStatLogger.FILE_NAME).exists()
        log.flush()
        log.close()
        return before, (d / lg.BlockStatLogger.FILE_NAME).read_text(
        ).splitlines()

    before, lines = both(tmp_path, run)
    assert before is False
    assert any(ln.startswith(f"{T0}|svc,FlowException") for ln in lines)


@pytest.mark.parametrize("max_lines", [None, 2])
def test_block_log_line_budget_and_keys(tmp_path, max_lines):
    """The 5-part key, the per-line token bucket and its ``__dropped__``
    summary line, alike in both packages."""
    def run(st, lg, clk_cls, d):
        clk = clk_cls(start_ms=T0)
        log = lg.BlockStatLogger(clk, base_dir=str(d),
                                 max_lines_per_sec=max_lines)
        for i in range(5):
            log.log(f"r{i}", "FlowException", limit_app="default",
                    origin="o", rule_id=str(i), count=i + 1)
        clk.advance_ms(1000)
        log.log("r0", "DegradeException")
        log.close()
        return (d / lg.BlockStatLogger.FILE_NAME).read_text().splitlines()

    lines = both(tmp_path, run)
    assert f"{T0}|r4,FlowException,default,o,4|5" in lines or max_lines
    assert any("__dropped__" in ln for ln in lines) == bool(max_lines)
