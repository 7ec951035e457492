"""The traffic generator: the same requests for one seed, other ones for
another, the same lengths in each block whatever the seed."""

import collections

import pytest

from port_bench import files, traffic


@pytest.fixture(params=["longprompt", "chat"])
def mix(request):
    return files.load_json("traffic", request.param)


def stream(mix, seed, n=200, vocab=1000):
    gen = traffic.ClosedLoop(mix, vocab, seed)
    return [gen.request(i) for i in range(n)]


def test_same_seed_same_requests(mix):
    assert stream(mix, 2 ** 31 + 77) == stream(mix, 2 ** 31 + 77)


def test_other_seed_other_requests(mix):
    a, b = stream(mix, 5), stream(mix, 6)
    assert [p for p, _ in a] != [p for p, _ in b]
    assert [traffic.ClosedLoop(mix, 1000, 5).shape(i) for i in range(200)] != \
        [traffic.ClosedLoop(mix, 1000, 6).shape(i) for i in range(200)]


def test_blocks_hold_the_same_lengths(mix):
    blk = mix["block"]
    a, b = traffic.ClosedLoop(mix, 1000, 1), traffic.ClosedLoop(mix, 1000, 2 ** 32 + 5)
    first = -(-mix["clients"] // blk)  # past the blocks that start the loop
    for k in range(first, first + 3):
        idx = range(k * blk, (k + 1) * blk)
        for pick in (0, 1):
            assert collections.Counter(a.shape(i)[pick] for i in idx) == \
                collections.Counter(b.shape(i)[pick] for i in idx)


def test_lengths_and_ids_in_range(mix):
    gen = traffic.ClosedLoop(mix, 1000, 3)
    for i in range(300):
        prompt, n_out = gen.request(i)
        assert mix["prompt"]["min"] <= len(prompt) <= mix["prompt"]["max"]
        assert 1 <= n_out <= mix["output"]["max"]
        if i >= mix["clients"]:
            assert n_out >= mix["output"]["min"]
        assert all(0 <= t < 1000 for t in prompt)


def test_fits_the_cells_sequences():
    for w in files.benchmark()["workloads"]:
        wl = files.load_json("workloads", w["name"])
        mix = files.load_json("traffic", wl["traffic"])
        assert mix["prompt"]["max"] + mix["output"]["max"] <= wl["engine"]["max_seq"]
        assert mix["clients"] == wl["engine"]["max_batch"]


def test_stratified_quantiles():
    lens = traffic._stratified({"dist": "uniform", "min": 1, "max": 4}, 8)
    assert sorted(lens.tolist()) == [1, 1, 2, 2, 3, 3, 4, 4]
    lens = traffic._stratified({"dist": "loguniform", "min": 100, "max": 10000}, 4)
    assert lens.tolist() == sorted(lens.tolist()) and lens[0] >= 100 and lens[-1] <= 10000


def test_first_requests_weighted_by_length():
    # a log-uniform's lengths weighted by length lie uniform over its range
    spec = {"dist": "loguniform", "min": 10, "max": 1000}
    w = traffic._length_weighted(spec, 100)
    assert 10 <= w.min() and w.max() <= 1000
    assert abs(float(w.mean()) - 505) < 15
    assert float(traffic._stratified(spec, 100).mean()) < 250
