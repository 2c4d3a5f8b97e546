"""Dynamic-batching inference serving (``veles_tpu/serving``).

* :mod:`.model_store` -- serveable models, named and versioned;
* :mod:`.replica` -- warm replicas with power-of-two batch buckets,
  grown and shrunk under live traffic;
* :mod:`.engine` -- the dynamic batcher;
* :mod:`.cache` -- the content-addressed, epoch-fenced result cache;
* :mod:`.admission` -- per-tenant weighted-fair admission;
* :mod:`.autoscale` -- the telemetry-driven replica autoscaler;
* :mod:`.metrics` -- QPS, queue depth, occupancy and latency tails;
* :mod:`.frontend` -- the HTTP frontend and the ``serve`` command
  (multi-model routes, 503 + Retry-After on overload, 504 past a client
  deadline, the observability endpoints).
"""
