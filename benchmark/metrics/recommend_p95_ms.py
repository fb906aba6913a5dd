"""recommend_p95_ms: the 95th percentile of the traced window's requests,
each from its due time to the last byte of its reply (the load generator's
clock), in ms. A per-layer reading: the tail swings with stalls of the
server's process that last a second or more, too widely to hold a bound."""


def read(obs):
    return obs.host.get("recommend_p95_ms")
