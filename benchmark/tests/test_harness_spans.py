"""The readers of the cards' idle time under the program's spans
(``benchmark/spans.py``, ``metrics/{init,loop,drain,mesh,unnamed}_idle``):
on made-up traces they read the overlap of idle stretches and spans, the
parts add up to the window's idle time, and without a trace, device events
or spans they read nothing."""

import json
import random
import types

import pytest

from benchmark import searches, spans
from benchmark.tests import tiny
from benchmark.trace import Trace

READERS = ("init_idle_ms", "loop_idle_us", "drain_idle_ms", "mesh_idle_ms",
           "unnamed_idle_ms")


def _read(name, run):
    return searches.load_module(
        tiny.BENCH / "metrics" / f"{name}.py").read(run)


def _run(tr, cards=(0,)):
    return types.SimpleNamespace(trace=tr, cards=tuple(cards))


def _trace(device, host, window=(0.0, 1000.0)):
    return Trace(window=window, searches=[], device=device,
                 host=sorted(host), events=0)


def _one_search():
    """One card, one search: init, two rounds of a launch each, a drain.
    The card's idle stretches: [0, 50], [80, 120], [280, 320], [480, 600],
    [650, 1000]."""
    device = {0: [(50.0, 80.0, "k"), (120.0, 280.0, "board_shared_kernel"),
                  (320.0, 480.0, "board_shared_kernel"), (600.0, 650.0, "k")]}
    host = [(0.0, 700.0, "mcq.search"), (0.0, 100.0, "mcq.init"),
            (100.0, 300.0, "mcq.round"), (110.0, 130.0, "mcq.launch"),
            (300.0, 500.0, "mcq.round"), (305.0, 330.0, "mcq.launch"),
            (500.0, 700.0, "mcq.drain"), (10.0, 20.0, "aten::empty")]
    return _trace(device, host)


def test_one_search_by_hand():
    run = _run(_one_search())
    assert _read("init_idle_ms", run) == pytest.approx(0.070)
    assert _read("loop_idle_us", run) == pytest.approx(80.0 / 2)
    assert _read("drain_idle_ms", run) == pytest.approx(0.150)
    assert _read("unnamed_idle_ms", run) == pytest.approx(0.300)
    assert _read("mesh_idle_ms", run) is None  # no mesh span


def test_mesh_spans_nested_and_several_cards():
    """Two cards; a gather nested in another span and two shards' enqueues
    count once each where they overlap an idle stretch of either card."""
    device = {0: [(0.0, 400.0, "k")], 1: [(200.0, 1000.0, "k")]}
    host = [(0.0, 1000.0, "mcq.search"), (0.0, 1000.0, "mcq.round"),
            (100.0, 300.0, "mcq.mesh.shard"), (300.0, 500.0, "mcq.exchange"),
            (350.0, 450.0, "mcq.mesh.gather"),
            (360.0, 440.0, "mcq.mesh.gather"),
            (600.0, 700.0, "mcq.meshy")]  # not under mcq.mesh.
    run = _run(_trace(device, host), cards=(0, 1))
    # card 0 idle [400, 1000]: under the gather [400, 450] = 50 us;
    # card 1 idle [0, 200]: under the shard [100, 200] = 100 us.
    assert _read("mesh_idle_ms", run) == pytest.approx(0.150 / 2)
    assert _read("init_idle_ms", run) is None  # no init span


@pytest.mark.parametrize("seed", range(6))
def test_parts_add_up_to_the_window_idle(seed):
    """(init + drain + unnamed) x searches x cards + loop x launches is the
    window's idle time summed over the cards, and every part lies in it."""
    rnd = random.Random(seed)
    cards = tuple(range(rnd.choice((1, 2, 4))))
    host, t = [], rnd.uniform(2, 20)
    n_search = rnd.randint(1, 3)
    for _ in range(n_search):
        s0 = t
        t += rnd.uniform(5, 30)
        host.append((s0, t, "mcq.init"))
        for _ in range(rnd.randint(1, 5)):
            r0 = t
            for _ in range(rnd.randint(1, 3) * len(cards)):
                a = t + rnd.uniform(0, 3)
                t = a + rnd.uniform(1, 5)
                host.append((a, t, "mcq.launch"))
            t += rnd.uniform(0, 10)
            host.append((r0, t, "mcq.round"))
        d0 = t
        t += rnd.uniform(5, 40)
        host.append((d0, t, "mcq.drain"))
        host.append((s0 - rnd.uniform(0, 2), t + rnd.uniform(0, 2),
                     "mcq.search"))
        t += rnd.uniform(1, 10)
    window = (0.0, t + 5)
    device = {}
    for c in cards:
        evs, x = [], rnd.uniform(0, 10)
        while x < window[1]:
            d = rnd.uniform(0.5, 15)
            evs.append((x, x + d, "k"))
            x += d + rnd.choice((0.0, rnd.uniform(0, 8)))
        device[c] = sorted(evs)
    tr = _trace(device, host, window)
    run = _run(tr, cards)
    launches = sum(1 for h in host if h[2] == "mcq.launch")
    total_ms = sum(spans.idle(tr, cards)) * 1e-3
    parts = {name: _read(name, run) for name in READERS}
    assert parts["mesh_idle_ms"] is None
    per_search = (parts["init_idle_ms"] + parts["drain_idle_ms"]
                  + parts["unnamed_idle_ms"])
    got = per_search * n_search * len(cards) + (
        parts["loop_idle_us"] * launches * 1e-3)
    assert got == pytest.approx(total_ms, rel=1e-9, abs=1e-9)
    for name in ("init_idle_ms", "drain_idle_ms", "unnamed_idle_ms",
                 "loop_idle_us"):
        assert parts[name] >= -1e-9


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    tr = _one_search()
    assert _read(name, _run(None)) is None
    assert _read(name, _run(_trace({}, tr.host))) is None
    # The parent program: device events, the harness's spans, none of its
    # own.
    harness = [(0.0, 1000.0, "bench.window"), (0.0, 700.0, "bench.search"),
               (10.0, 20.0, "aten::empty")]
    assert _read(name, _run(_trace(tr.device, harness))) is None


def test_manifest_entries():
    """Each new metric is in BENCHMARK.json with a cell group's name,
    moves that group's end-to-end metric and lists that metric's cells."""
    manifest = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    ours = [m for m in manifest["per_layer"]
            if m["name"].split(".", 1)[0] in READERS]
    assert len(ours) == 13
    for m in ours:
        group = m["name"].split(".", 1)[1]
        assert m["moves"] == f"moves_per_s.{group}"
        assert m["workloads"] == e2e[m["moves"]]["workloads"]
        assert m["source"] == "device_trace"


def test_cpu_run_records_the_spans(tmp_path, monkeypatch):
    """A traced run of a small sharded floors cell on the CPU: its trace
    holds one mcq.search, mcq.init and mcq.drain a search and the
    cell's launches on every shard, and with no device events the new
    metrics are left out of the result."""
    from benchmark import trace as trace_mod

    root = tiny.checkout(tmp_path)
    seen = []
    real = trace_mod.from_profiler

    def keep(prof):
        seen.append(real(prof))
        return seen[-1]

    monkeypatch.setattr(trace_mod, "from_profiler", keep)
    out = tiny.run(root, "tiny_3d.floors_x4", trace=True)
    assert out["correct"]
    (tr,) = seen
    n = out["attempted"]
    assert spans.count(tr, ("mcq.search",)) == n
    for name in ("mcq.init", "mcq.drain"):
        assert spans.count(tr, (name,)) == n
    from benchmark import run as run_mod

    _, cell = run_mod.load_cell(root, "tiny_3d.floors_x4")
    assert cell.shards == 4
    assert spans.count(tr, ("mcq.launch",)) == (
        n * len(cell.launches()) * cell.shards)
    assert spans.count(tr, ("mcq.round",)) == n * len(cell.launches())
    assert spans.count(tr, ("mcq.mesh.",)) > 0
    assert not [m for m in out["metrics"]
                if m.split(".", 1)[0] in READERS]
