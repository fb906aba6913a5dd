"""eval_ms: one `Trainer.evaluate` pass (the eval forward and the sampled
metrics), the mean over the window's passes, in ms."""


def read(obs):
    spans = obs.spans.named("evaluate", *obs.window)
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / len(spans) * 1e3
