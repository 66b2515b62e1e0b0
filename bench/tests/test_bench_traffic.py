"""The traffic generator: reproducible from the seed, and the same work
for every seed."""
import numpy as np
import pytest

from bench.harness import spec, traffic


@pytest.mark.parametrize("name", ["chat", "chat-long-prompt", "rag"])
def test_same_seed_same_batch(name):
    tr = spec.traffic(name)
    a = traffic.batch(tr, 2 ** 31 + 11, 0, 49152)
    b = traffic.batch(tr, 2 ** 31 + 11, 0, 49152)
    assert len(a) == tr["batch_requests"]
    for (pa, ma), (pb, mb) in zip(a, b):
        assert ma == mb and np.array_equal(pa, pb)


@pytest.mark.parametrize("name", ["chat", "chat-long-prompt", "rag"])
def test_every_seed_does_the_same_work(name):
    tr = spec.traffic(name)
    for i in (0, 1):
        sizes = {tuple((len(p), m) for p, m in traffic.batch(tr, seed, i,
                                                             1000))
                 for seed in (1, 7, 2 ** 31 + 3)}
        assert len(sizes) == 1              # same sizes, same order
    # the batches of a run differ in order; the seeds in tokens
    a0, a1 = traffic.batch(tr, 1, 0, 1000), traffic.batch(tr, 1, 1, 1000)
    assert sorted((len(p), m) for p, m in a0) == \
        sorted((len(p), m) for p, m in a1)
    assert [(len(p), m) for p, m in a0] != [(len(p), m) for p, m in a1]
    b0 = traffic.batch(tr, 2, 0, 1000)
    assert any(not np.array_equal(pa, pb) for (pa, _), (pb, _) in
               zip(a0, b0))


def test_counts_and_lengths():
    tr = {"batch_requests": 10, "prompt_buckets": [512, 1024, 2048],
          "prompt_weights": [0.3, 0.5, 0.2],
          "output": {"dist": "lognormal", "median": 96, "sigma": 0.6,
                     "min": 16, "max": 256}}
    ps = traffic.pairs(tr)
    lens = sorted(p for p, _ in ps)
    assert lens == [512] * 3 + [1024] * 5 + [2048] * 2
    outs = sorted(o for _, o in ps)
    assert outs[0] >= 16 and outs[-1] <= 256
    assert outs[len(outs) // 2] in range(80, 115)       # about the median
    uni = traffic._output_lengths(25, {"dist": "uniform", "min": 8,
                                       "max": 32})
    assert sorted(uni) == list(range(8, 33))
    assert traffic.max_output(tr) == outs[-1]


def test_tokens_within_vocab():
    tr = spec.traffic("chat")
    for p, m in traffic.batch(tr, 5, 3, 300):
        assert p.dtype == np.int32 and p.min() >= 0 and p.max() < 300
        assert len(p) in tr["prompt_buckets"] and m >= 1


def test_shared_prefixes_are_data_alone():
    """Sessions sharing system prompts: a traffic file's `shared_prefix`
    puts one of k prefixes drawn from the seed at the head of each prompt,
    the same in every batch of the run; the sizes stay as they were."""
    plain = {"batch_requests": 6, "prompt_buckets": [64, 128],
             "prompt_weights": [0.5, 0.5],
             "output": {"dist": "uniform", "min": 2, "max": 5}}
    tr = dict(plain, shared_prefix={"lengths": [32, 96]})
    seed = 2 ** 31 + 21
    heads = {}
    for i in (0, 1):
        got, base = traffic.batch(tr, seed, i, 500), \
            traffic.batch(plain, seed, i, 500)
        assert [(len(p), m) for p, m in got] == \
            [(len(p), m) for p, m in base]
        for j, ((p, _), (q, _)) in enumerate(zip(got, base)):
            n = min([32, 96][j % 2], len(p))
            h = heads.setdefault(j % 2, p[:n].copy())
            m = min(n, len(h))
            assert np.array_equal(p[:m], h[:m])
            if n > len(h):
                heads[j % 2] = p[:n].copy()
            assert np.array_equal(p[n:], q[n:])     # the rest its own
    other = traffic.batch(tr, seed + 1, 0, 500)
    assert not np.array_equal(other[0][0][:32], heads[0][:32])
