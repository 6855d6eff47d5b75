"""The port's LMEngine against the reference's on the CPU (tinyllama smoke,
fp32, the reference's params bridged as numpy): equal greedy tokens for
the reference's own engine test (tests/test_models.py) and for prompts of
mixed lengths, so that slot positions diverge and slots step in turns;
EOS and max_seq retirement; slot reuse; seeded temperature sampling."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as RM
from repro.serving.engine import LMEngine as RefLMEngine
from repro.serving.engine import Request as RefRequest
from repro_torch import bridge, configs
from repro_torch.models import model as MD
from repro_torch.serving.engine import LMEngine, Request


@pytest.fixture(scope="module")
def model():
    ref_cfg = dataclasses.replace(ref_configs.get_smoke("tinyllama-1.1b"), dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    params = RM.init(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, params, bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _both(model, prompts, max_new, **engine_kw):
    ref_cfg, cfg, params, ported = model
    expect = RefLMEngine(params, ref_cfg, **engine_kw).run(
        [RefRequest(prompt=p, max_new_tokens=n, id=i) for i, (p, n) in enumerate(zip(prompts, max_new))])
    eng = LMEngine(ported, cfg, device="cpu", **engine_kw)
    got = eng.run([Request(prompt=p, max_new_tokens=n, id=i) for i, (p, n) in enumerate(zip(prompts, max_new))])
    return expect, got, eng


def test_same_prompt_as_the_reference_engine_test(model):
    """tests/test_models.py::TestServingEngine's setup: 3 requests of one
    prompt on 2 slots, so the third reuses a slot."""
    expect, got, _ = _both(model, [[1, 2, 3, 4, 5]] * 3, [5] * 3, slots=2, max_seq=48, prefill_chunk=4)
    assert [c.id for c in got] == [0, 1, 2]
    assert [c.tokens for c in got] == [c.tokens for c in expect]
    assert got[0].tokens == got[1].tokens == got[2].tokens


def test_mixed_prompt_lengths_match_the_reference(model):
    """Six prompts of 2-9 tokens on 3 slots: positions diverge, slots at
    different positions step in turns, finished slots take new requests."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).tolist() for n in (3, 7, 5, 9, 2, 6)]
    max_new = [6, 7, 8, 9, 10, 11]
    expect, got, eng = _both(model, prompts, max_new, slots=3, max_seq=24, prefill_chunk=4)
    assert [c.tokens for c in got] == [c.tokens for c in expect]
    assert [len(c.tokens) for c in got] == max_new
    assert eng.steps > sum(len(p) - 1 for p in prompts)  # prefill and decode steps


def test_retirement_matches_the_reference(model):
    """max_seq ends the long requests early; an EOS id ends any request
    that emits it."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).tolist() for n in (9, 3, 6)]
    expect, got, _ = _both(model, prompts, [12, 12, 12], slots=2, max_seq=12, prefill_chunk=4)
    assert [c.tokens for c in got] == [c.tokens for c in expect]
    assert [len(c.tokens) for c in got] == [3, 9, 6]  # stops once pos reaches max_seq - 1
    eos = got[1].tokens[2]
    expect, got, _ = _both(model, prompts, [12, 12, 12], slots=2, max_seq=12, prefill_chunk=4, eos_id=eos)
    assert [c.tokens for c in got] == [c.tokens for c in expect]
    assert got[1].tokens[-1] == eos and len(got[1].tokens) <= 3


def test_matches_a_manual_decode_loop(model):
    """The engine's greedy tokens are those of decode_step run by hand."""
    _, cfg, _, ported = model
    eng = LMEngine(ported, cfg, slots=2, max_seq=32, prefill_chunk=3, device="cpu")
    (out,) = eng.run([Request(prompt=[7, 8, 9, 10, 11], max_new_tokens=6)])
    cache = MD.init_cache(cfg, 1, 32, device="cpu")
    for pos, t in enumerate([7, 8, 9, 10]):
        MD.decode_step(ported, torch.tensor([[t]]), cache, pos, cfg)
    cur, manual = 11, []
    for pos in range(4, 10):
        logits, _ = MD.decode_step(ported, torch.tensor([[cur]]), cache, pos, cfg)
        cur = int(torch.argmax(logits[0, -1]))
        manual.append(cur)
    assert out.tokens == manual
    assert eng.steps == 4 + 6


def test_temperature_sampling_is_seeded(model):
    _, cfg, _, ported = model

    def run(seed):
        eng = LMEngine(ported, cfg, slots=2, max_seq=32, device="cpu", generator=torch.Generator().manual_seed(seed))
        reqs = [Request(prompt=[1, 2, 3], max_new_tokens=8, temperature=1.5, id=i) for i in range(2)]
        return [c.tokens for c in eng.run(reqs)]

    a, b = run(0), run(0)
    assert a == b and all(0 <= t < cfg.vocab_size for toks in a for t in toks)
    assert a != run(1)


@pytest.mark.parametrize("argv,expect", [
    (["--engine", "lm", "-n", "3", "--max-new", "4"], "12 tokens in"),
    (["--engine", "segmentation", "-n", "1", "--volume", "16"], "success rate: 100.0%"),
])
def test_serve_launcher_runs_on_the_cpu(argv, expect, capsys):
    from repro_torch.launch import serve

    serve.main(argv + ["--device", "cpu"])
    assert expect in capsys.readouterr().out
