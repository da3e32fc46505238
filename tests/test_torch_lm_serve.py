"""Port vs reference: LM serving (``repro_torch.serve.engine``,
``launch.serve``) against ``repro.serve.ServeEngine`` run live on the
reference's weights.

The port's engine serves the reference's requests token for token (dense,
vlm and audio smoke configs, 6 requests at batch 4, uneven prompts and
budgets).  Its captured decode step (on the CPU the same static state,
stepped eagerly) is built once per engine and run once per decode step;
each batch resets the engine's cache in place to what ``init_cache``
returns, for every family.  The reference's own serving tests
(``tests/test_serve.py``) run on the port.
"""
import numpy as np
import pytest
import torch

from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, transformer
from repro_torch.models.registry import Model
from repro_torch.serve import Request, ServeEngine

import _lm_parity as P
from _port_share import port_share  # noqa: F401

FAMILIES = ["qwen1.5-0.5b", "pixtral-12b", "dbrx-132b", "zamba2-7b",
            "rwkv6-1.6b", "whisper-tiny"]


def _requests(cls, vocab: int, seed: int = 3, n: int = 6) -> list:
    """``n`` requests: prompts of 3-11 tokens, budgets of 2-5 tokens."""
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, vocab, size=(int(rng.integers(3, 12)),)
                                    ).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 6)))
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "pixtral-12b",
                                  "whisper-tiny"])
def test_engine_tokens_equal_the_reference_engines(arch):
    """6 requests at batch 4 (a full and a padded batch), the reference's
    weights, fp32 compute: every request's tokens equal."""
    cfg, _, m, rm, params, rp = P.pair(arch)
    max_len = 64 + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    want = RefServeEngine(rm, rp, batch_size=4, max_len=max_len).generate(
        _requests(RefRequest, cfg.vocab_size))
    eng = ServeEngine(m, params, batch_size=4, max_len=max_len, device="cpu")
    got = eng.generate(_requests(Request, cfg.vocab_size))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [len(r.out_tokens) for r in got] == [r.max_new_tokens
                                                for r in got]
    assert all(r.done for r in got)
    # one decode step built; one run of it per decode step of each batch
    assert eng.captures == 1
    budgets = [r.max_new_tokens for r in got]
    assert eng.replays == eng.decoder.replays == max(budgets[:4]) + max(
        budgets[4:])


@pytest.fixture(scope="module")
def engine():
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return ServeEngine(model, params, batch_size=4, max_len=64, device="cpu")


def test_generate_batch(engine):
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, 256, size=(8,)).astype(np.int32),
                max_new_tokens=5)
        for _ in range(6)  # more requests than the batch size
    ]
    out = engine.generate(reqs)
    assert all(r.done for r in out)
    assert all(len(r.out_tokens) == 5 for r in out)


def test_generation_deterministic(engine):
    p = np.arange(8, dtype=np.int32) % 250
    r1 = engine.generate([Request(prompt=p.copy(), max_new_tokens=6)])[0]
    r2 = engine.generate([Request(prompt=p.copy(), max_new_tokens=6)])[0]
    assert r1.out_tokens == r2.out_tokens


def test_decode_matches_prefill_continuation(engine):
    """Greedy decode continuation equals prefilling the extended prompt."""
    model, params = engine.model, engine.params
    p = np.arange(9, dtype=np.int32) % 250
    r = engine.generate([Request(prompt=p.copy(), max_new_tokens=3)])[0]
    ext = np.concatenate([p, np.asarray(r.out_tokens[:1], np.int32)])
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(
            ext[None])}, model.init_cache(1, 64, device="cpu"))
    assert int(torch.argmax(logits[0, -1])) == r.out_tokens[1]


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_batch_resets_the_engine_cache_to_init_cache(arch):
    """After a batch, ``reset_cache`` writes the engine's own cache tensors
    (the decode step's static state) back to a fresh ``init_cache``, leaf
    by leaf and bit for bit; the next batch serves as a fresh engine
    would."""
    cfg = get_smoke_config(arch)
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(1))
    max_len = 32 + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    eng = ServeEngine(m, params, batch_size=2, max_len=max_len, device="cpu")
    first = eng.generate(_requests(Request, cfg.vocab_size, seed=5, n=2))
    static = eng.decoder.static
    cache = eng.reset_cache()
    fresh = m.init_cache(2, max_len, device="cpu")
    assert sorted(cache) == sorted(fresh)
    for k in fresh:
        assert cache[k] is static[k]
        assert cache[k].dtype == fresh[k].dtype
        assert cache[k].shape == fresh[k].shape
        assert cache[k].equal(fresh[k]), k
    again = eng.generate(_requests(Request, cfg.vocab_size, seed=5, n=2))
    assert [r.out_tokens for r in again] == [r.out_tokens for r in first]
    assert eng.captures == 1


def test_a_decode_step_that_rebinds_its_cache_is_refused():
    """The captured step needs every cache leaf written in place: a model
    that returns a new tensor for a leaf raises instead of serving from a
    cache the next batch's reset would not reach."""
    cfg = get_smoke_config("qwen1.5-0.5b")

    class Rebinding:
        schema, init_cache, prefill = (transformer.schema,
                                       transformer.init_cache,
                                       transformer.prefill)

        @staticmethod
        def decode_step(params, cfg, token, cache):
            logits, cache = transformer.decode_step(params, cfg, token, cache)
            return logits, dict(cache, k=cache["k"].clone())

    m = Model(cfg=cfg, module=Rebinding)
    params = m.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(m, params, batch_size=2, max_len=32, device="cpu")
    with pytest.raises(RuntimeError, match="in place"):
        eng.generate([Request(np.arange(4, dtype=np.int32), 2)])


def test_engine_limits():
    cfg = get_smoke_config("qwen1.5-0.5b")
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cache entry"):
        ServeEngine(m, params, 2, 32, cache_shardings={}, device="cpu")
    eng = ServeEngine(m, params, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate([Request(np.arange(4, dtype=np.int32), 9)])


def test_serve_launcher(capsys):
    launch_serve.main(["--arch", "qwen1.5-0.5b", "--requests", "3",
                       "--batch", "2", "--new-tokens", "3", "--max-len",
                       "48", "--device", "cpu"])
    assert "qwen1.5-0.5b: 3 requests, 9 tokens" in capsys.readouterr().out
