"""The port's synthetic data pipeline (``repro_torch.data.synthetic``).

The reference's tests/test_data.py on CPU tensors: determinism per step,
steps differ, host shards are disjoint, targets are the tokens shifted,
the stream resumes exactly, tokens lie in the vocabulary, the repetition
structure is there. The draws come from a ``torch.Generator`` seeded from
(seed, step, host), so the tokens are not the reference's; the
properties, and the shapes and dtypes, are.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.synthetic import make_batch as jmake_batch
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticStream, make_batch

CFG = get_config("qwen3-1.7b", smoke=True)
CPU = {"device": "cpu"}


def _np(batch, key="tokens"):
    return batch[key].numpy()


def test_deterministic_per_step():
    a = make_batch(CFG, step=3, seed=1, batch=4, seq=32, **CPU)
    b = make_batch(CFG, step=3, seed=1, batch=4, seq=32, **CPU)
    np.testing.assert_array_equal(_np(a), _np(b))


def test_steps_differ():
    a = make_batch(CFG, step=3, seed=1, batch=4, seq=32, **CPU)
    b = make_batch(CFG, step=4, seed=1, batch=4, seq=32, **CPU)
    assert not np.array_equal(_np(a), _np(b))


def test_seeds_differ():
    a = make_batch(CFG, step=3, seed=1, batch=4, seq=32, **CPU)
    b = make_batch(CFG, step=3, seed=2, batch=4, seq=32, **CPU)
    assert not np.array_equal(_np(a), _np(b))


def test_host_shards_disjoint_streams():
    a = make_batch(CFG, step=0, seed=1, host=0, n_hosts=2, batch=8, seq=32,
                   **CPU)
    b = make_batch(CFG, step=0, seed=1, host=1, n_hosts=2, batch=8, seq=32,
                   **CPU)
    assert a["tokens"].shape == (4, 32)      # batch split across hosts
    assert not np.array_equal(_np(a), _np(b))


def test_targets_are_shifted_tokens():
    a = make_batch(CFG, step=0, seed=1, batch=2, seq=16, **CPU)
    np.testing.assert_array_equal(_np(a)[:, 1:], _np(a, "targets")[:, :-1])


def test_stream_resume_exact():
    s1 = SyntheticStream(CFG, seed=5, batch=2, seq=16, **CPU)
    next(s1)
    next(s1)
    st = s1.state_dict()
    want = next(s1)

    s2 = SyntheticStream(CFG, seed=0, batch=2, seq=16, **CPU)
    s2.load_state_dict(st)
    got = next(s2)
    np.testing.assert_array_equal(_np(want), _np(got))
    assert s2.state_dict() == {"step": 3, "seed": 5}


def test_tokens_in_vocab():
    a = make_batch(CFG, step=0, seed=2, batch=4, seq=64, **CPU)
    t = np.concatenate([_np(a), _np(a, "targets")])
    assert t.min() >= 3 and t.max() < CFG.vocab_size


def test_repetition_structure_learnable():
    """The stream must have predictable structure (repetitions), i.e. the
    empirical copy rate is well above chance."""
    a = _np(make_batch(CFG, step=0, seed=3, batch=16, seq=256, **CPU))
    match = 0
    for row in a:
        for lag in range(1, 64):
            match = max(match, (row[lag:] == row[:-lag]).mean())
    assert match > 0.2   # copy structure present


def test_shapes_dtypes_and_marginals_match_the_reference():
    """Same shapes and dtypes as the reference's batch, and the same
    Zipf-ish marginal: the share of tokens below V/16 (u**4 puts half the
    mass there) agrees within sampling noise."""
    jcfg = jget("qwen3-1.7b", smoke=True)
    want = jmake_batch(jcfg, step=0, seed=4, batch=16, seq=256)
    got = make_batch(CFG, step=0, seed=4, batch=16, seq=256, **CPU)
    for key in ("tokens", "targets"):
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.int32
        assert str(want[key].dtype) == "int32"
    def low(t):
        return float((np.asarray(t) < CFG.vocab_size // 16).mean())

    assert abs(low(got["tokens"]) - low(want["tokens"])) < 0.05


def test_batches_are_made_on_the_card_by_default():
    if torch.cuda.is_available():
        assert make_batch(CFG, step=0)["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_batch(CFG, step=0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SyntheticStream(CFG)
