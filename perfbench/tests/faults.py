"""Faults planted under the harness in the CPU tests, to see ``correct``
come out false (each a module attribute of the program replaced in the
test's own process):

- ``token``: a served token altered where the engine produces it;
- ``state``: a decode step that leaves the cache as it found it (the
  new token's key and value are not kept);
- ``half``: half of the requests left out (the engine answers every
  second prompt with nothing, so its copies fail).
A cell that runs on one chip has no exchange between chips to leave
out."""
from __future__ import annotations

FAULTS = ("none", "token", "state", "half")


def plant(name: str) -> None:
    """Plant fault ``name`` once the harness's set-up is done, so that it
    breaks the timed path (the warm request runs sound)."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    if name == "none":
        return
    from perfbench import harness
    prepare = harness.prepare

    def prepared(*a, **k):
        s = prepare(*a, **k)
        _plant(name)
        return s
    harness.prepare = prepared


def _plant(name: str) -> None:
    from repro_torch.serving import engine
    orig = engine.InferenceEngine.generate
    if name == "token":
        def generate(self, prompt, max_new_tokens=16, check_cancel=None):
            out = orig(self, prompt, max_new_tokens, check_cancel)
            if out is not None:
                out = out.copy()
                out[-1] = (out[-1] + 1) % self.cfg.vocab_size
            return out
        engine.InferenceEngine.generate = generate
    elif name == "half":
        def generate(self, prompt, max_new_tokens=16, check_cancel=None):
            if int(sum(int(t) for t in prompt)) % 2:
                return None
            return orig(self, prompt, max_new_tokens, check_cancel)
        engine.InferenceEngine.generate = generate
    else:
        from repro_torch.models import attention
        orig_step = attention.decode_attention

        def decode_attention(p, x, cache, pos, **kw):
            slot = pos % cache["pos"].shape[0]
            keep = (cache["k"][:, slot].clone(), cache["v"][:, slot].clone(),
                    cache["pos"][slot].clone())
            out = orig_step(p, x, cache, pos, **kw)
            cache["k"][:, slot], cache["v"][:, slot] = keep[0], keep[1]
            cache["pos"][slot] = keep[2]
            return out
        attention.decode_attention = decode_attention
