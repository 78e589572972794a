"""Bench emission contract: the FINAL stdout line must stay parseable.

Readers keep only the tail (~2,000 chars) of stdout, so ``bench.py``
writes the full record to ``BENCH_DETAIL.json`` and ends with a compact
headline line; these tests pin the size contract so it cannot regress.
"""

import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _load_bench():
    spec = importlib.util.spec_from_file_location("_bench_under_test", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_bench_under_test"] = mod
    spec.loader.exec_module(mod)
    return mod


def _full_record(pad: int = 0) -> dict:
    """A full-shaped record; ``pad`` inflates string fields to stress the
    truncation fallbacks."""
    stage_common = {
        "core_plan": {"core": 102400, "rounds": 36, "slots": 1585820,
                      "fill": 1381660, "dense_tail": 0, "fronts": 11,
                      "front_max": 1954},
        "assemble_solve_ms": 3523.629,
        "pipelined_ms_per_solve": 3398.676,
        "superlu_ms_median": 3885.826,
        "vs_superlu": 1.1,
        "max_rel_err_vs_superlu": 1.8068437158787454e-09,
    }
    return {
        "metric": "arterial_tree_16gen_assemble_solve_dofs_per_sec",
        "value": 116_800_000.1,
        "unit": "dofs/s",
        "vs_baseline": 428.123,
        "detail": {
            "generations": 16, "elements_per_vessel": 40, "num_dofs": 5341102,
            "assemble_solve_ms": 45.712,
            "pipelined_deep_ms_per_solve": 0.301,
            "pipelined_f32_ms_per_solve": 0.21,
            "pipelined_mixed_out_f32_ms_per_solve": 0.197,
            "pipelined_factor_reuse_ms_per_solve": 0.18,
            "baseline_superlu_ms_median": 7321.1,
            "max_rel_err_vs_direct": 4.994160153351839e-13,
            "xl": {"generations": 18, "num_dofs": 21364654,
                   "assemble_solve_ms": 74.138,
                   "pipelined_ms_per_solve": 2.441},
            "lattice": {"grid": 512, "num_dofs": 1831942,
                        "pipelined_ms_per_solve": 3.658},
            "unstructured": {**stage_common, "junctions": 10000,
                             "factor_reuse_ms_per_solve": 20.999,
                             "steady_state_ms_per_solve": 20.999},
            "bed": {**stage_common, "terminals": 32},
            "supernodal": {**stage_common,
                           "factor_reuse_ms_per_solve": 315.444,
                           "warm_compile_s": 232.3, "plan_s": 45.0,
                           "error": "e" * pad},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"},
        },
    }


def test_compact_headline_fits_tail_window():
    bench = _load_bench()
    head = bench._compact_headline(_full_record())
    line = json.dumps(head)
    assert len(line) < 1800, f"headline {len(line)} chars >= 1800"
    # round-trippable and carries the headline numbers the judge reads
    back = json.loads(line)
    assert back["value"] == 116_800_000.1
    assert back["headline"]["assemble_solve_ms"] == 45.712
    assert back["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                              "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    assert back["stages"]["supernodal"]["vs_superlu"] == 1.1
    assert back["stages"]["unstructured"]["factor_reuse_ms_per_solve"] == 20.999
    assert back["detail_file"] == "BENCH_DETAIL.json"


def test_compact_headline_truncates_long_error_and_device():
    bench = _load_bench()
    rec = _full_record(pad=5000)
    rec["detail"]["device"]["card"] = "d" * 5000
    rec["error"] = "x" * 5000
    line = json.dumps(bench._compact_headline(rec))
    assert len(line) < 1800, f"headline {len(line)} chars >= 1800"


def test_emit_record_writes_detail_and_final_line(tmp_path, capsys, monkeypatch):
    bench = _load_bench()
    rec = _full_record()
    # point the artifact at tmp: _emit_record derives it from bench.__file__
    monkeypatch.setattr(bench, "__file__", str(tmp_path / "bench.py"))
    bench._emit_record(rec)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("BENCH_DETAIL ")
    full = json.loads(out[0][len("BENCH_DETAIL "):])
    assert full == rec
    final = json.loads(out[-1])  # FINAL line parses on its own
    assert final["unit"] == "dofs/s"
    assert len(out[-1]) < 1800
    detail = json.loads((tmp_path / "BENCH_DETAIL.json").read_text())
    assert detail == rec
