"""One driver per kind of traffic: `run(ctx) -> core.Outcome`."""
