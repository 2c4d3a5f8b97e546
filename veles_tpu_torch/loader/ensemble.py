"""Ensemble-results loader (``veles_tpu/loader/ensemble.py``).

Feeds the stacked per-member predictions from an ensemble results JSON
(``EnsembleTester`` output, each member carrying ``Output`` and
``Labels`` lists) as the dataset of a stacking meta-model: sample #i is
the ``(n_members, n_classes)`` matrix of member outputs for input #i.

The refusals are the JAX loader's: no member results, a member without
a recorded ``Output`` or with an empty one, an output shape other than
member #0's, and labels in another order than member #0's (the members'
test runs saw the samples in different orders).
"""

import json

import numpy
import torch

from veles_tpu_torch.loader.base import TEST, TRAIN, VALIDATION
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class EnsembleLoader(FullBatchLoader):
    """Member predictions from a results JSON as a device-resident batch:
    ``original_data`` (n, members, classes) float32, the first member's
    labels as ``original_labels``, every sample in the TEST class under
    ``--test`` and in TRAIN otherwise."""

    MAPPING = "ensemble"

    def __init__(self, workflow=None, file=None, data=None, **kwargs):
        super(EnsembleLoader, self).__init__(workflow=workflow, **kwargs)
        self.file = file
        self.data = data  # already parsed (tests)

    def _read(self):
        if self.data is not None:
            return self.data
        if not self.file:
            raise ValueError("EnsembleLoader needs file= or data=")
        with open(self.file) as f:
            return json.load(f)

    def load_dataset(self):
        data = self._read()
        members = [m for m in data.get("models", []) if isinstance(m, dict)]
        if not members:
            raise ValueError("no member results in %s" % (self.file,))
        outputs, labels_ref = [], None
        for index, member in enumerate(members):
            if "Output" not in member:
                raise ValueError("member #%d has no recorded Output "
                                 "(train members with publish_output=True)"
                                 % index)
            output = numpy.asarray(member["Output"], dtype=numpy.float32)
            labels = member.get("Labels")
            if output.shape[0] == 0:
                raise ValueError("member #%d recorded an empty Output"
                                 % index)
            if outputs and output.shape != outputs[0].shape:
                raise ValueError(
                    "member #%d output shape %s != member #0 shape %s" %
                    (index, output.shape, outputs[0].shape))
            if labels is not None:
                labels = numpy.asarray(labels)
                if labels_ref is None:
                    labels_ref = labels
                elif not numpy.array_equal(labels, labels_ref):
                    raise ValueError(
                        "member #%d saw samples in a different order — "
                        "re-run member tests with a fixed seed" % index)
            outputs.append(output)
        stacked = numpy.stack(outputs, axis=1)  # (n, members, classes)
        self.original_data = torch.from_numpy(stacked)
        if labels_ref is not None:
            self.original_labels = torch.from_numpy(
                labels_ref.astype(numpy.int32).reshape(len(labels_ref)))
        klass = TEST if self.testing else TRAIN
        self.class_lengths[TEST] = self.class_lengths[VALIDATION] = \
            self.class_lengths[TRAIN] = 0
        self.class_lengths[klass] = stacked.shape[0]

    @property
    def testing(self):
        return bool(getattr(self.launcher, "testing", False))
