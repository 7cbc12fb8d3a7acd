"""The harness is driven by data: a cell added as files is picked up."""

import hashlib
import json

from benchmark.tests import tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_cell_runs_without_editing_a_file(tmp_path):
    root = tiny.checkout(tmp_path)
    before = _digests(root / "benchmark")
    workload = json.loads(
        (root / "benchmark/workloads/board_n16.anneal.json").read_text())
    workload.update(check_chains=2, warmup_segments=1)
    tiny.add_cell(root, "tiny_board.throwaway", "tiny_board", workload,
                  like="board_n16.anneal")
    out = tiny.run(root, "tiny_board.throwaway")
    after = _digests(root / "benchmark")
    added = set(after) - set(before)
    assert {str(p) for p in added} == {"workloads/tiny_board.throwaway.json"}
    assert all(after[p] == before[p] for p in before)
    assert out["correct"] and out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"moves_per_s.board", "setup_s"}
    assert out["metrics"]["moves_per_s.board"]["unit"] == "moves/s"
    assert list(out)[-1] == "checks"
    assert out["checks"]["replay"] == {"value": 0, "limit": 0}


def test_every_cell_has_its_files():
    manifest = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    names = {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        assert w["config"] in names
        assert (tiny.BENCH / "workloads" / f"{w['name']}.json").is_file()
        workload = json.loads(
            (tiny.BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (tiny.BENCH / "kinds" / f"{workload['search']}.py").is_file()
    for c in manifest["configs"]:
        assert (tiny.REPO / c["file"]).is_file()
        family = json.loads((tiny.REPO / c["file"]).read_text())["family"]
        assert (tiny.BENCH / "reference" / f"{family}.py").is_file()
        assert (tiny.BENCH / "work" / f"{family}.py").is_file()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        reader = m["name"].split(".", 1)[0]
        assert (tiny.BENCH / "metrics" / f"{reader}.py").is_file()
