"""One driver per kind of traffic: train, eval, serve."""
