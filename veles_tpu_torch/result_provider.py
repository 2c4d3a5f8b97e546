"""Result-provider contract (the port's copy of
``veles_tpu/result_provider.py``).

Units that publish final metrics (validation error, RMSE, fitness)
implement ``get_metric_values()``; the workflow aggregates them into the
``--result-file`` JSON (``veles/workflow.py:827-849``).
"""


class IResultProvider(object):
    """Mixin marker: implement get_metric_values() -> dict."""

    def get_metric_values(self):
        raise NotImplementedError
