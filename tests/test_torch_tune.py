"""The port's plan-time probe-chunk tuner (engine/tune.py) and its use in
plan_join, on the CPU, mirroring tests/test_tune.py: the default off
the card, HJK_TUNE=0, the degenerate candidate sets, the cache key (its
candidate set and device name), merge-on-write, and which errors give
the default.  A fake card (the device gate and the name patched, the
timing stubbed) reaches the cache path.  plan_join equals the JAX
plan_join exactly on the CPU, tuner branch included."""

import json
import os

import pytest
import torch

from hash_join_codes_knl_tpu.engine.config import plan_join as jax_plan_join
from hash_join_codes_knl_tpu_torch.engine import tune
from hash_join_codes_knl_tpu_torch.engine.config import plan_join
from hash_join_codes_knl_tpu_torch.engine.convert import plan_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_card(monkeypatch):
    """Past the off-card gate, a fake device name, and a timer that
    makes the smallest candidate fastest and counts its calls."""
    calls = []

    def timed(outer_n, C, tile, reps, device):
        calls.append(C)
        return float(C)

    monkeypatch.setattr(tune, "_tuning_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(tune, "_device_name", lambda device: "FakeCard")
    monkeypatch.setattr(tune, "_time_sort", timed)
    monkeypatch.delenv("HJK_TUNE", raising=False)
    return calls


def _key(n, cands, tile=3072):
    return (f"{n}|{tile}|{','.join(map(str, cands))}|{torch.__version__}"
            "|FakeCard")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_default_off_the_card(device):
    if device is None and torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    assert tune.tuned_probe_chunks(256_000_000, default=64,
                                   device=device) == 64


def test_disabled_by_env(monkeypatch, fake_card):
    monkeypatch.setenv("HJK_TUNE", "0")
    assert tune.tuned_probe_chunks(256_000_000, default=48) == 48
    assert fake_card == []


def test_degenerate_candidate_sets(fake_card):
    assert tune.tuned_probe_chunks(1_000_000, candidates=(56,),
                                   default=64) == 56
    assert tune.tuned_probe_chunks(1_000_000, candidates=(),
                                   default=64) == 64
    assert fake_card == []


def test_cache_key_names_candidates_and_device(tmp_path, fake_card):
    path = str(tmp_path / "tune.json")
    with open(path, "w") as f:
        json.dump({_key(1_000_000, (48, 56)): {"C": 56,
                                               "times": {"56": 0.1}}}, f)
    # a verdict timed under a narrower set does not serve the wide set
    assert tune.tuned_probe_chunks(1_000_000, cache_path=path) == 48
    assert fake_card == [48, 56, 64, 72]
    cache = json.load(open(path))
    # merge-on-write: the earlier entry stays beside the new one
    assert cache[_key(1_000_000, (48, 56))]["C"] == 56
    entry = cache[_key(1_000_000, tune.DEFAULT_CANDIDATES)]
    assert entry == {"C": 48, "times": {"48": 48.0, "56": 56.0,
                                        "64": 64.0, "72": 72.0}}
    # the matching key is served from the cache, untimed
    cache[_key(1_000_000, tune.DEFAULT_CANDIDATES)]["C"] = 72
    json.dump(cache, open(path, "w"))
    assert tune.tuned_probe_chunks(1_000_000, cache_path=path) == 72
    assert len(fake_card) == 4
    # another tile is another key
    assert tune.tuned_probe_chunks(1_000_000, tile=1024,
                                   cache_path=path) == 48
    assert len(fake_card) == 8


def test_env_cache_path_and_default_file(tmp_path, monkeypatch, fake_card):
    path = tmp_path / "env.json"
    monkeypatch.setenv("HJK_TUNE_CACHE", str(path))
    assert tune.tuned_probe_chunks(2_000_000) == 48
    assert _key(2_000_000, tune.DEFAULT_CANDIDATES) in json.load(open(path))
    monkeypatch.delenv("HJK_TUNE_CACHE")
    # the port's own cache file, never the JAX package's, and ignored by git
    assert tune._cache_path() == os.path.join(REPO, ".hjk_tune_torch.json")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".hjk_tune_torch.json" in ignored


def test_unreadable_or_unwritable_cache(tmp_path, fake_card):
    bad = tmp_path / "torn.json"
    bad.write_text("{not json")
    assert tune.tuned_probe_chunks(3_000_000, cache_path=str(bad)) == 48
    missing_dir = str(tmp_path / "no_such_dir" / "tune.json")
    assert tune.tuned_probe_chunks(3_000_000, cache_path=missing_dir) == 48
    assert not os.path.exists(missing_dir)


def test_out_of_memory_gives_the_default_uncached(tmp_path, monkeypatch,
                                                  fake_card):
    def oom(*a):
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr(tune, "_time_sort", oom)
    path = tmp_path / "tune.json"
    assert tune.tuned_probe_chunks(4_000_000, default=60,
                                   cache_path=str(path)) == 60
    assert not path.exists()


def test_other_errors_raise(tmp_path, monkeypatch, fake_card):
    def fault(*a):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tune, "_time_sort", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tune.tuned_probe_chunks(5_000_000, cache_path=str(tmp_path / "t"))


@pytest.mark.parametrize("ni,no", [
    (16_000_000, 256_000_000),  # the headline: tuner branch, C=64
    (16_000_000, 64_000_000),  # the stream chunk: c_win 16, untimed
    (16_000_000, 200_000_000),  # c_win 50: one candidate
    (4_000_000, 64_000_000),
    (32_000_000, 512_000_000),  # past 320M: global sort
    (1_000_000, 8_000_000),
])
def test_plan_join_equals_jax_on_cpu(ni, no):
    want = plan_from_jax(jax_plan_join(ni, no))
    assert plan_join(ni, no, device="cpu") == want
    if not torch.cuda.is_available():
        assert plan_join(ni, no) == want


def test_plan_join_takes_the_tuned_count(monkeypatch):
    seen = []

    def tuned(outer_n, tile, default, candidates, device):
        seen.append((outer_n, tile, default, candidates, device))
        return 56

    monkeypatch.setattr(tune, "tuned_probe_chunks", tuned)
    assert plan_join(16_000_000, 256_000_000, device="cuda").probe_chunks \
        == 56
    # the candidates are narrowed by the window cap, the default is
    # min(64, c_win), and the actual tile is passed
    plan_join(16_000_000, 200_000_000, tile=3072, device="cuda")
    assert seen == [(256_000_000, 3072, 64, (48, 56, 64), "cuda"),
                    (200_000_000, 3072, 50, (48,), "cuda")]
