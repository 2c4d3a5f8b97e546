"""Known-bad fixture: metric-contract drift, through the port's
registry. Never imported."""

from veles_tpu_torch.telemetry.registry import get_registry


def mint(job_id):
    registry = get_registry()
    # MET001: family absent from the docs/torch/OBSERVABILITY.md catalog
    ghost = registry.counter(
        "veles_fixture_ghost_total", "family no catalog row mentions",
        labels=("job",))
    # MET002: unbounded label value (f-string interpolation)
    ghost.labels(job=f"job-{job_id}").inc()
    # MET002: %-format label value
    ghost.labels(job="job-%s" % job_id).inc()
    return ghost
