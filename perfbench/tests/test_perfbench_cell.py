"""A cell added only as new files, run end to end on the CPU at smoke
size in a fresh process from a temporary checkout; the same run with the
timed path broken underneath comes out not correct; and the files of
``BENCHMARK.json`` meet its contract."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import harness, spec
from perfbench.tests import helpers

OPEN_MIX = {"loop": "open", "arrivals": "poisson", "rate_share": 0.5,
            "prompt_len": {"dist": "log_uniform", "lo": 8, "hi": 40},
            "new_tokens": {"dist": "uniform_int", "lo": 1, "hi": 4},
            "requests": 256, "schedule_seed": 5}
# short prompts, so that a decode step's lost key moves the next token
CLOSED_MIX = {"loop": "closed", "clients": 4,
              "prompt_len": {"dist": "log_uniform", "lo": 2, "hi": 6},
              "new_tokens": {"dist": "uniform_int", "lo": 3, "hi": 4},
              "requests": 4096, "schedule_seed": 6}
# the smoke models' served tokens lie at 0 below the float32 reference's
# best on every seed tried; a wrong token lies far below it
LIMITS = {"served_gap": 0.5}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return helpers.checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("family,mix,metrics", [
    ("dense", OPEN_MIX, {"latency_mean_ms", "latency_p85_ms", "setup_s"}),
    ("moe", CLOSED_MIX, {"tokens_per_s", "setup_s"})])
def test_new_cell_from_files_only_runs_on_the_cpu(root, family, mix,
                                                   metrics):
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file() and p.parent.name != "__pycache__"
              and p.name != "BENCHMARK.json"}
    port, ref = ((helpers.TINY_DENSE, "dense_gqa") if family == "dense"
                 else (helpers.TINY_MOE, "moe_gqa"))
    cell = helpers.add_cell(root, f"tiny-{family}", port, ref, mix,
                            {"sustained_rate_per_s": 40.0, "limits": LIMITS})
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file of the benchmark was edited
    r = helpers.run_cpu(root, cell, 2**31 + 17, 1.5)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 10
    assert set(r["metrics"]) == metrics
    assert list(r)[-1] == "check"
    assert r["check"]["served_gap"]["value"] <= LIMITS["served_gap"]


def test_traced_run_reads_host_metrics_from_an_untraced_window(root):
    """With ``--trace 1`` the run measures two windows, the schedule
    running on: the per-layer metrics of the host clock come from the
    first, the trace from the second, shorter, and both windows' requests
    are checked."""
    cell = helpers.add_cell(root, "tiny-traced", helpers.TINY_DENSE,
                            "dense_gqa", OPEN_MIX,
                            {"sustained_rate_per_s": 40.0, "limits": LIMITS})
    one = helpers.run_cpu(root, cell, 2**31 + 19, 1.5)
    r = helpers.run_cpu(root, cell, 2**31 + 19, 1.5, trace=True)
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert {"copies_per_request.lat", "decode_step_ms.lat"} <= set(r["metrics"])
    assert "latency_mean_ms" not in r["metrics"]
    assert r["attempted"] > 1.25 * one["attempted"]
    assert abs(r["device"]["window_s"] - harness.TRACED_SHARE * 1.5) < 0.1
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


# the MoE smoke model's served logits lie within 0.02 of the bf16
# reference's (in units of the row's RMS) on every seed tried; a decode
# step that keeps no key moves the later positions' by 1.3 or more, and
# the median over all positions not at all
MOE_LIMITS = {"logit_error_median": 0.35, "logit_error": 0.5}
DENSE = ("dense", helpers.TINY_DENSE, "dense_gqa", LIMITS, "float32")
MOE = ("moe", helpers.TINY_MOE, "moe_gqa", MOE_LIMITS, "bf16")


@pytest.mark.parametrize("family,fault", [
    pytest.param(DENSE, f, id=f) for f in ("token", "state", "half")] + [
    pytest.param(MOE, f, id=f"moe-{f}") for f in ("token", "state", "half")])
def test_broken_timed_path_is_not_correct(root, family, fault):
    kind, port, ref, limits, precision = family
    cell = helpers.add_cell(root, f"{kind}-{fault}", port, ref, CLOSED_MIX,
                            {"limits": limits}, sample=64,
                            precision=precision)
    sound = helpers.run_cpu(root, cell, 1234567890123, 1.0)
    assert sound["correct"], sound["check"]
    broken = helpers.run_cpu(root, cell, 1234567890123, 1.0, fault)
    assert not broken["correct"], broken["check"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_meets_its_contract():
    s = spec.load_spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= s["run_seconds"] <= 51 and s["paths"] == ["perfbench"]
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    names += [w["name"] for w in s["workloads"]]
    names += [c["name"] for c in s["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    layers = {}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        spec.metric_reader(m["name"])  # a reader file of its own
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], []).append(m["name"])
    confs = {c["name"]: c for c in s["configs"]}
    for w in s["workloads"]:
        cell = spec.find_cell(w["name"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert cell.end_to_end and cell.per_layer
        assert w["config"] in confs
        spec.reference(cell.config["reference"])
        assert set(cell.own["limits"]) & {"served_gap", "logit_error",
                                        "logit_error_median"}


def test_config_files_are_the_programs_configs():
    from repro_torch.configs.base import get_config
    from perfbench.harness import model_config
    for c in spec.load_spec()["configs"]:
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        cfg = model_config(conf["port"])
        assert cfg == get_config(c["name"])
        assert conf["reduced"] == c["reduced"] == []
        assert (conf["hidden_size"], conf["num_hidden_layers"],
                conf["num_attention_heads"], conf["num_key_value_heads"],
                conf["vocab_size"]) == (cfg.d_model, cfg.n_layers,
                                        cfg.n_heads, cfg.n_kv_heads,
                                        cfg.vocab_size)
        assert conf["parameters"] == cfg.param_count
        assert conf["tie_word_embeddings"] == cfg.tie_embeddings
