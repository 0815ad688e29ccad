"""Each reference agrees with the program's smoke models on the CPU
(the plain path, the model widened to float32), through prefill and the
decode steps over the cache; and the control, the reference in fp8,
reads larger gaps than the program on the same served tokens."""
from __future__ import annotations

import pytest
import torch

from perfbench import harness, spec, weights
from perfbench.tests import helpers


def _program_logits(model, tokens, n_new, max_len=64):
    from repro_torch.models import decode as dec
    logits, cache = dec.prefill(model, tokens, max_len, kernel="off")
    rows, tok, served = [logits[0]], logits.argmax(-1), []
    served.append(int(tok))
    for i in range(n_new - 1):
        logits, cache = dec.decode_step(model, cache, tok[:, None],
                                        tokens.shape[1] + i, kernel="off")
        rows.append(logits[0])
        tok = logits.argmax(-1)
        served.append(int(tok))
    return torch.stack(rows), served


@pytest.mark.parametrize("port,ref,capacity", [
    (helpers.TINY_DENSE, "dense_gqa", None),
    (helpers.TINY_MOE, "moe_gqa", 1.25),    # drops past the capacity
    (helpers.TINY_MOE, "moe_gqa", 8.0)])
def test_reference_matches_the_smoke_model(port, ref, capacity):
    from repro_torch.models import layers, lm
    port = dict(port)
    if capacity is not None:
        port["moe"] = dict(port["moe"], capacity_factor=capacity)
    mod = spec.reference(ref)
    model = lm.init(layers.MetaGenerator(), harness.model_config(port))
    weights.materialize(model, 2**33 + 3, torch.device("cpu"), mod.fan_in)
    model.float()
    w = dict(model.named_parameters())
    g = torch.Generator().manual_seed(5)
    lens, gots, seqs = (1, 7, 40), [], []
    for s in lens:
        toks = torch.randint(0, port["vocab_size"], (1, s), generator=g)
        got, served = _program_logits(model, toks, 4)
        gots.append(got)
        seqs.append(torch.cat([toks[0], torch.tensor(served[:-1])]))
    # all three sequences in one call, as the check runs them
    wants = mod.logits_at(w, port, seqs, list(lens),
                          [list(range(s - 1, s + 3)) for s in lens])
    for s, got, want in zip(lens, gots, wants):
        scale = want.abs().max()
        assert (got - want).abs().max() <= 1e-5 * scale, (s, scale)


@pytest.mark.parametrize("port,ref", [(helpers.TINY_DENSE, "dense_gqa"),
                                      (helpers.TINY_MOE, "moe_gqa")])
def test_bf16_reference_follows_the_bf16_program(port, ref):
    """At the configuration's own precision the reference lands far
    closer to the program than the float32 reference does."""
    from repro_torch.models import layers, lm
    mod = spec.reference(ref)
    model = lm.init(layers.MetaGenerator(), harness.model_config(port))
    weights.materialize(model, 77, torch.device("cpu"), mod.fan_in)
    w = dict(model.named_parameters())
    toks = torch.randint(0, port["vocab_size"], (1, 33),
                         generator=torch.Generator().manual_seed(8))
    got, served = _program_logits(model, toks, 4)
    seq = torch.cat([toks[0], torch.tensor(served[:-1])])
    rows = [list(range(32, 36))]
    bf = mod.logits_at(w, port, [seq], [33], rows, precision="bf16")[0]
    f32 = mod.logits_at(w, port, [seq], [33], rows)[0]
    assert (got - bf).abs().max() < 0.25 * (got - f32).abs().max()


def test_control_reads_larger_gaps_than_the_program(tmp_path):
    """The control at a size a test run holds: the smoke model's served
    tokens lie within 1e-3 of the float32 reference's best (bf16
    rounding), the reference in fp8 puts tokens first that lie 0.1 and
    more below it; a limit of 0.02 parts them."""
    import json
    import subprocess
    import sys
    root = helpers.checkout(tmp_path)
    mix = {"loop": "closed", "clients": 4,
           "prompt_len": {"dist": "log_uniform", "lo": 8, "hi": 40},
           "new_tokens": {"dist": "uniform_int", "lo": 3, "hi": 4},
           "requests": 4096, "schedule_seed": 9}
    cell = helpers.add_cell(root, "tiny-ctl", helpers.TINY_DENSE,
                            "dense_gqa", mix, {"limits": {"served_gap": 0.5}},
                            sample=48)
    p = subprocess.run([sys.executable, "perfbench/control.py", "--workload",
                        cell, "--seconds", "1.5", "--seeds", "1", "2", "3"],
                       cwd=root, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    assert len(rows) == 3
    for r in rows:
        assert r["served_gap"] <= 0.02 < r["control_gap"], r
        assert r["logit_error"] < r["control_logit_error"], r
