"""Known-bad fixture: alert rules over unminted families (MET003).
The filename ends in ``alerts.py`` on purpose — that is how the
checker recognises a rule pack. Never imported."""

DEFAULT_RULES = (
    {"name": "phantom_rate",
     "metric": "veles_fixture_never_minted_total",
     "kind": "absent", "for_s": 60.0},
    {"name": "phantom_burn",
     "numerator": "veles_fixture_also_never_minted_total",
     "denominator": "veles_step_ms",
     "kind": "ratio", "threshold": 0.5, "for_s": 120.0},
)


def mint_real(registry):
    # veles_step_ms IS minted (here), so only the phantom families
    # above may be flagged by MET003
    return registry.histogram("veles_step_ms", "per-step wall time")
