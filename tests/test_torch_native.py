"""Port parity: the native C++ interning tables (``sentinel_tpu_torch.
native``, ``rules.param_flow.NativeParamKeyRegistry``) against the JAX
package's C++ tables and the port's pure-Python tables.

Twins of the 9 tests of ``tests/test_native_registry.py`` and the 6 of
``tests/test_param_key_native.py``: every scenario runs on the JAX
package's C++ table, the port's C++ table and the port's Python table,
and their observations (rows, evictions, drains, overrides, errors) must
agree row for row — exactly, no tolerance. Then the key canonicalization
on mixed types, the factories and the runtime's batch intern: a default
``Sentinel`` interns through the C++ tables, ``SENTINEL_TPU_NATIVE=0``
gives the Python ones, the library is built into
``sentinel_tpu_torch/_build/`` only, and a failed build is logged once.
The library is built here with ``g++``, as on the card machine.
"""

import logging
import os
import random
import threading

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu import native as jnative
from sentinel_tpu.rules import param_flow as jpf
from sentinel_tpu_torch import native as tnative
from sentinel_tpu_torch.core import registry as treg
from sentinel_tpu_torch.ops import _build
from sentinel_tpu_torch.rules import param_flow as tpf

torch.set_num_threads(2)

if not (jnative.native_available() and tnative.native_available()):
    pytest.skip("g++ did not build the native tables",
                allow_module_level=True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name tables: the reference's C++ table, the port's, the port's Python
NAMES = {"jax_native": jnative.NativeRegistry,
         "torch_native": tnative.NativeRegistry,
         "torch_python": treg.Registry}
#: param key tables, likewise
KEYS = {"jax_native": jpf.NativeParamKeyRegistry,
        "torch_native": tpf.NativeParamKeyRegistry,
        "torch_python": tpf.ParamKeyRegistry}


def agree(tables, scenario):
    """``scenario(make)`` for each table class → the port's C++ table's
    observations, equal to the other two tables'."""
    got = {name: scenario(cls) for name, cls in tables.items()}
    assert got["torch_native"] == got["jax_native"]
    assert got["torch_python"] == got["jax_native"]
    return got["torch_native"]


def _outcome(fn):
    try:
        return fn()
    except RuntimeError:
        return "ALL_PINNED"


# ------------------------------------------------------------ name tables

def test_factory_returns_native(monkeypatch):
    assert isinstance(treg.make_registry(16), tnative.NativeRegistry)
    assert isinstance(treg.make_resource_registry(16),
                      tnative.NativeRegistry)
    assert isinstance(treg.make_origin_registry(16), tnative.NativeRegistry)
    assert isinstance(tpf.make_param_key_registry(16),
                      tpf.NativeParamKeyRegistry)
    monkeypatch.setenv("SENTINEL_TPU_NATIVE", "0")
    assert type(treg.make_registry(16)) is treg.Registry
    assert type(tpf.make_param_key_registry(16)) is tpf.ParamKeyRegistry
    r = treg.make_resource_registry(4)
    assert r.lookup(treg.ENTRY_NODE_NAME) == treg.ENTRY_NODE_ROW


def test_differential_vs_python_registry():
    """One random op sequence → identical ids, evictions, lengths,
    lookups and all-pinned errors in all three tables."""
    def sc(cls):
        rng = random.Random(42)
        names = [f"res-{i}" for i in range(40)]
        t = cls(16, reserved=("__r__",))
        out = []
        for _ in range(3000):
            op = rng.random()
            name = rng.choice(names)
            if op < 0.55:
                out.append(_outcome(lambda: t.get_or_create(name)))
            elif op < 0.70:
                out.append(t.lookup(name))
            elif op < 0.80:
                out.append(_outcome(lambda: t.pin(name)))
            elif op < 0.90:
                t.unpin(name)
            else:
                out.append(sorted(t.drain_evicted()))
            out.append(len(t))
        return out, sorted(t.items())
    agree(NAMES, sc)


def test_name_of_and_capacity_guard():
    def sc(cls):
        r = cls(4)
        rid = r.get_or_create("hello")
        try:
            cls(1, reserved=("a",))
            small = "built"
        except ValueError:
            small = "ValueError"
        return [rid, r.name_of(rid), r.name_of(99), r.name_of(-1),
                r.capacity, small]
    assert agree(NAMES, sc) == [0, "hello", None, None, 4, "ValueError"]


def test_all_pinned_overflow_raises():
    def sc(cls):
        r = cls(3)
        rows = [r.pin(n) for n in ("a", "b", "c")]
        return rows, _outcome(lambda: r.get_or_create("overflow")), len(r)
    assert agree(NAMES, sc)[1] == "ALL_PINNED"


def test_batch_matches_scalar_path():
    """The batch intern (one call for the whole batch, the dedup and
    all-identical shortcuts past 64 names) against the scalar path, while
    the table has room: rows equal in all three tables."""
    batches = ([f"n{i % 10}" for i in range(50)], ["same"] * 100,
               [f"m{i % 7}" for i in range(200)])

    def sc(cls):
        r1, r2 = cls(64), cls(64)
        out = []
        for names in batches:
            batch = getattr(r1, "get_or_create_batch", None)
            b = (batch(names).tolist() if batch is not None
                 else [r1.get_or_create(n) for n in names])
            assert b == [r2.get_or_create(n) for n in names]
            out.append(b)
        return out
    agree(NAMES, sc)


def test_batch_intern_eviction_order_matches_the_reference():
    """Past the table's room the batch's dedup shortcut refreshes LRU
    order by first appearance, the scalar path by last (ROADMAP C15, the
    reference's behaviour): the port's C++ table follows the reference's
    C++ table there row for row, and its Python table the reference's
    scalar order."""
    batches = ([f"m{i % 7}" for i in range(200)],
               [f"w{i}" for i in range(100)],
               [f"m{i % 9}" for i in range(150)] + ["w3"] * 20)

    def run(cls, batch_path):
        r = cls(64, reserved=("__r__",))
        out = []
        for names in batches:
            rows = (r.get_or_create_batch(names).tolist() if batch_path
                    else [r.get_or_create(n) for n in names])
            out.append((rows, sorted(r.drain_evicted())))
        return out, sorted(r.items())
    native = run(tnative.NativeRegistry, True)
    assert native == run(jnative.NativeRegistry, True)
    assert run(treg.Registry, False) == run(jnative.NativeRegistry, False)
    assert native != run(treg.Registry, False)      # C15, as the reference


def test_unicode_names():
    def sc(cls):
        r = cls(8)
        rid = r.get_or_create("ресурс-例")
        return [rid, r.lookup("ресурс-例"), r.name_of(rid), r.items()]
    assert agree(NAMES, sc)[2] == "ресурс-例"


@pytest.mark.parametrize("table", ["torch_native", "torch_python"])
def test_thread_safety_no_duplicate_ids(table):
    """8 threads intern one shared set of names (the C++ call runs
    without the GIL): every thread sees every name on one row, and no
    two names share a row; batch interns race the scalar ones."""
    r = NAMES[table](256)
    results = [None] * 8

    def work(t):
        local = {}
        for i in range(2000):
            name = f"shared-{i % 100}"
            if t % 2 and i % 50 == 0 and hasattr(r, "get_or_create_batch"):
                names = [f"shared-{(i + k) % 100}" for k in range(100)]
                for n, row in zip(names, r.get_or_create_batch(names)):
                    assert local.setdefault(n, int(row)) == int(row)
            else:
                row = r.get_or_create(name)
                assert local.setdefault(name, row) == row
        results[t] = local

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name in results[0]:
        assert len({results[t][name] for t in range(8)}) == 1, name
    assert len(set(results[0].values())) == len(results[0]) == 100
    assert sorted(r.items()) == sorted(results[0].items())


def test_eviction_reuses_rows_and_reports_them():
    def sc(cls):
        r = cls(4, reserved=("keep",))
        first = [r.get_or_create(f"x{i}") for i in range(3)]
        r.get_or_create("x0")            # touch: the LRU is x1
        rid = r.get_or_create("new")
        return [first, rid, r.drain_evicted(), r.lookup("keep"),
                r.drain_evicted()]
    first, rid, drained, keep, again = agree(NAMES, sc)
    assert rid == first[1] and drained == [first[1]]
    assert keep is not None and again == []


def test_very_long_names_roundtrip():
    def sc(cls):
        r = cls(4)
        long_name = "я" * 5000           # 10k UTF-8 bytes, > the 4096 buffer
        rid = r.get_or_create(long_name)
        return [rid, r.name_of(rid) == long_name,
                dict(r.items())[long_name]]
    assert agree(NAMES, sc) == [0, True, 0]


# --------------------------------------------------------- param key tables

def test_row_assignment_and_hits_match():
    def sc(cls):
        reg = cls(8)
        out = [reg.get_or_create(0, "a"), reg.get_or_create(0, "b"),
               reg.get_or_create(1, "a"), reg.get_or_create(0, "a"),
               reg.get_or_create(0, 42), reg.get_or_create(0, 42)]
        r1 = reg.get_or_create(2, 1)
        out += [r1, reg.get_or_create(2, True), reg.get_or_create(2, 1.0),
                len(reg)]
        return out
    assert agree(KEYS, sc) == [0, 1, 2, 0, 3, 3, 4, 4, 4, 5]


def test_key_canonicalization_on_mixed_types():
    """Values a dict treats as one key share a row in every table:
    ``True``/``1``/``1.0``/``np.int64(1)``/``np.float32(1)``, ``-0.0`` and
    ``0``; big ints past int64, tuples, ``None`` inside tuples, floats
    and strings (a gateway's IPs and headers) take rows of their own. A
    tuple equal to another but of another repr (``(1.0, 2)`` against
    ``(1, 2)``) is one key in the Python tables and two in the C++ ones,
    in both packages (the reference's documented bounded divergence)."""
    values = [1, True, 1.0, np.int64(1), np.int32(1), np.float32(1.0),
              np.bool_(True), 0, False, -0.0, 2 ** 63, 2 ** 63, -(2 ** 63),
              -(2 ** 63) - 1, 2 ** 70, (1, 2), (1, 2), ("a", None),
              1.5, np.float64(1.5), "1", "10.0.0.1", "10.0.0.1",
              "X-Tenant: a", "$NM", "$D", "я", 7, 7.0]

    def sc(vals):
        def run(cls):
            reg = cls(64)
            rows = [reg.get_or_create(3, v) for v in vals]
            rows += reg.get_or_create_batch([(4, v, None) for v in vals])
            return rows, len(reg)
        return run
    rows, n = agree(KEYS, sc(values))
    assert rows[:7] == [rows[0]] * 7 and rows[7] == rows[8] == rows[9]
    exotic = sc(values + [(1.0, 2)])
    nat = exotic(tpf.NativeParamKeyRegistry)
    assert nat == exotic(jpf.NativeParamKeyRegistry)
    assert exotic(tpf.ParamKeyRegistry) == exotic(jpf.ParamKeyRegistry)
    assert nat[1] == exotic(tpf.ParamKeyRegistry)[1] + 2


def test_lru_eviction_order_and_drain_match():
    def sc(cls):
        reg = cls(8)
        rows = [reg.get_or_create(0, i) for i in range(8)]
        reg.get_or_create(0, 3)                  # touch: 3 becomes MRU
        r_new = reg.get_or_create(0, 100)        # evicts the LRU (key 0)
        ev, ov = reg.drain_updates()
        return [rows, r_new, ev, ov, reg.get_or_create(0, 0),
                reg.drain_updates()]
    got = agree(KEYS, sc)
    assert got[2] == [0] and got[1] == 0


def test_pins_block_eviction_and_unpin_releases():
    def sc(cls):
        reg = cls(8)
        rows = [reg.get_or_create(0, i) for i in range(8)]
        reg.pin_rows(np.asarray(rows[:7], np.int32))
        a = reg.get_or_create(0, 100)
        b = reg.get_or_create(0, 101)
        reg.pin_rows(np.asarray([b], np.int32))
        full = _outcome(lambda: reg.get_or_create(0, 102))
        reg.unpin_rows(np.asarray([b], np.int32))
        c = reg.get_or_create(0, 103)
        reg.pin_rows(np.asarray([rows[0], rows[0]], np.int32))
        reg.unpin_rows(np.asarray([rows[0]], np.int32))
        return [rows, a, b, full, c, reg.live_pin_count(),
                reg.drain_updates()]
    got = agree(KEYS, sc)
    assert got[1] == got[2] == got[4] == got[0][7]
    assert got[3] == "ALL_PINNED" and got[5] == 8


def test_override_on_create_and_cancel_on_evict():
    def sc(cls):
        reg = cls(8)
        r = reg.get_or_create(0, "k", override=7)
        reg.get_or_create(0, "k", override=9)    # a hit: no new override
        first = (r, reg.drain_updates())
        r2 = reg.get_or_create(0, "k2", override=5)
        for i in range(8):
            reg.get_or_create(1, i)
        ev, ov = reg.drain_updates()
        return [first, (r2, sorted(ev), ov)]
    got = agree(KEYS, sc)
    assert got[0] == (0, ([], [(0, 7.0)]))
    assert got[1][2] == []                       # k2's override cancelled


def test_int_batch_fast_path_matches_scalar_form():
    slots = np.array([0, 0, 1, 0, 2, 2], np.int64)
    vals = np.array([5, -3, 5, 7, -(2 ** 31) + 1, 2 ** 31 - 1], np.int64)
    packed = slots * (2 ** 32) + (vals + 2 ** 31)

    def sc(cls):
        reg = cls(8)
        fast = getattr(reg, "get_or_create_int_batch", None)
        rows = (fast(packed).tolist() if fast is not None else
                [reg.get_or_create(int(s), int(v))
                 for s, v in zip(slots, vals)])
        again = [reg.get_or_create(int(s), int(v))
                 for s, v in zip(slots, vals)]
        assert again == rows
        return rows, len(reg)
    assert agree(KEYS, sc) == ([0, 1, 2, 3, 4, 5], 6)


def test_randomized_trace_parity():
    def sc(cls):
        rng = np.random.default_rng(11)
        reg = cls(16)
        pinned, out = [], []
        for _ in range(400):
            op = rng.integers(0, 10)
            if op < 6:
                slot = int(rng.integers(0, 3))
                v = (int(rng.integers(0, 30)) if rng.random() < 0.7
                     else f"s{int(rng.integers(0, 20))}")
                ov = int(rng.integers(1, 50)) if rng.random() < 0.1 else None
                out.append(_outcome(
                    lambda: reg.get_or_create(slot, v, override=ov)))
            elif op < 7:
                items = [(int(rng.integers(0, 3)), int(rng.integers(0, 30)),
                          None) for _ in range(int(rng.integers(1, 8)))]
                out.append(_outcome(lambda: reg.get_or_create_batch(items)))
            elif op < 8 and len(reg) > 2:
                rows = np.asarray(
                    rng.integers(0, 16, int(rng.integers(1, 4))), np.int32)
                reg.pin_rows(rows)
                pinned.append(rows)
            elif op < 9 and pinned:
                reg.unpin_rows(pinned.pop())
            else:
                out.append(reg.drain_updates())
            out.append(len(reg))
        return out
    agree(KEYS, sc)


# ----------------------------------------------------- the runtime's tables

def _runtimes(monkeypatch, tmp_path, native: bool):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TPU_NATIVE", "1" if native else "0")
    out = {}
    for name, pkg in (("jax", stpu), ("torch", stt)):
        extra = {"device": "cpu"} if name == "torch" else {}
        out[name] = pkg.Sentinel(pkg.load_config(
            max_resources=64, max_origins=16, param_table_slots=32,
            host_fast_path=False), clock=pkg.ManualClock(
                start_ms=1_785_000_000_000), **extra)
    return out


@pytest.mark.parametrize("native", [True, False])
def test_runtime_tables_and_batch_intern(monkeypatch, tmp_path, native):
    """A default ``Sentinel`` interns names (``entry_batch``: one batch
    call), origins, contexts and param keys through the C++ tables, or
    the Python ones under ``SENTINEL_TPU_NATIVE=0``; both packages give
    the same rows, evictions and verdicts, and the runtime's state
    agrees."""
    from sentinel_tpu.core.context import ContextScope as jscope
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.context import ContextScope as tscope
    ctx = {"jax": jscope, "torch": tscope}
    sides = _runtimes(monkeypatch, tmp_path, native)
    t = sides["torch"]
    want_names = tnative.NativeRegistry if native else treg.Registry
    want_keys = (tpf.NativeParamKeyRegistry if native
                 else tpf.ParamKeyRegistry)
    for reg in (t.resources, t.origins, t.contexts):
        assert type(reg) is want_names
    assert type(t.param_key_registry) is want_keys
    rng = np.random.default_rng(5)
    batches = [[f"n{int(v)}" for v in rng.integers(0, 90, 200)]
               for _ in range(6)]
    arg_list = [(int(a),) for a in rng.integers(0, 50, 100)]
    got = {}
    for name, sph in sides.items():
        pkg = stpu if name == "jax" else stt
        sph.load_flow_rules([pkg.FlowRule(resource="n3", count=4.0)])
        sph.load_param_flow_rules([pkg.ParamFlowRule(
            resource="p", param_idx=0, count=2.0)])
        out = []
        for names in batches:          # 90 names on 64 rows: evictions
            out.append(np.asarray(sph.entry_batch(names).allow).tolist())
            sph.clock.advance_ms(300)
        v = sph.entry_batch(["p"] * 100, args_list=arg_list)
        out.append(np.asarray(v.allow).tolist())
        with ctx[name]("ctx-a", origin="app-a"):
            out.append(sph.entry_batch(["n1"] * 4).allow.tolist())
        out += [sorted(sph.resources.items()), sorted(sph.origins.items()),
                sorted(sph.contexts.items()), len(sph.param_key_registry)]
        got[name] = out
    assert got["torch"] == got["jax"]
    assert convert.leaf_diff(convert.to_numpy(sides["jax"]._state),
                             convert.to_numpy(t._state)) == []
    for sph in sides.values():
        sph.close()


def test_library_lands_in_build_dir_only():
    """The port's library is built from its own copy of the source into
    ``sentinel_tpu_torch/_build/`` under a hashed name, never next to
    the source or under the JAX package."""
    path = _build.build_host(tnative._SRC, "sentinel_native")
    assert os.path.dirname(path) == os.path.join(
        REPO, "sentinel_tpu_torch", "_build")
    assert os.path.isfile(path)
    assert tnative._SRC == os.path.join(
        REPO, "sentinel_tpu_torch", "native", "src", "registry.cpp")
    assert not [f for f in os.listdir(os.path.dirname(tnative._SRC))
                if f.endswith(".so")]
    with open(tnative._SRC, "rb") as a, open(os.path.join(
            REPO, "sentinel_tpu", "native", "src", "registry.cpp"),
            "rb") as b:
        body_a = a.read().split(b"#include", 1)[1]
        body_b = b.read().split(b"#include", 1)[1]
    assert body_a == body_b          # the same table, comments aside


def test_failed_build_falls_back_and_logs_once(monkeypatch, tmp_path):
    """A build that fails leaves the Python tables in place, with one
    line in the record log however often the factories ask."""
    from sentinel_tpu_torch.core import logs
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Catch()
    logs.record_log().addHandler(handler)
    monkeypatch.setattr(tnative, "_lib_handle", None)

    def broken(src, stem):
        raise RuntimeError("g++ failed for registry.cpp:\nerror: boom")
    monkeypatch.setattr(_build, "build_host", broken)
    try:
        assert type(treg.make_resource_registry(8)) is treg.Registry
        assert type(tpf.make_param_key_registry(8)) is tpf.ParamKeyRegistry
        assert not tnative.native_available()
    finally:
        logs.record_log().removeHandler(handler)
    assert len(records) == 1 and "g++ failed" in records[0]
