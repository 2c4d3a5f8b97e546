"""Inference packages (``veles_tpu/export``): a trained workflow's
forward chain as ``contents.json`` beside ``.npy`` members
(:mod:`.package`), which the C++ runtime under ``native/`` runs
(:mod:`.native`) and ``serving.model_store`` serves."""

from veles_tpu_torch.export.package import (export_workflow,  # noqa: F401
                                            load_package_info)
