"""kv_live_share (%, program counter): PagedKVPool.live_pages() / num_pages,
sampled after each step of the traced run's window, averaged."""


def read(obs):
    v = obs["kv_live"]
    return 100.0 * sum(v) / len(v) if v else None
