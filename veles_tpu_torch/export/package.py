"""The inference package writer (``veles_tpu/export/package.py``).

Package layout (an uncompressed POSIX tar, or a plain directory)::

    contents.json        workflow name and checksum, the ordered units
    @0000_64x10.npy      array members referenced from contents.json
    ...

``contents.json`` is the JAX package's, ``format_version`` 1: each
forward unit as ``{"class": {"name", "uuid"}, "data": {...}}`` with the
same exporters and keys, array values as ``@NNNN_shape`` strings naming
``.npy`` members, numbered in the order the units and their keys come.
Arrays are the units' parameters in the JAX layout
(``convert.to_jax_layout``: HWIO convolutions), so the package of a
port-trained workflow is what the JAX package writes for the same
weights, and both packages' readers and ``native/`` run it.

The JAX writer adds ``model.stablehlo``, a ``jax.export`` artifact of
the forward chain; the port has no StableHLO exporter and leaves that
member out.
"""

import io
import json
import os
import tarfile

import numpy

from veles_tpu_torch.convert import layer_params, to_jax_layout

#: unit class name -> its exporter
_EXPORTERS = {}

#: activations the native convolution applies per scalar
_CONV_ACTIVATIONS = ("linear", "tanh", "sigmoid", "relu", "strict_relu",
                     "leaky_relu", "log")


def exporter(*class_names):
    def register(fn):
        for name in class_names:
            _EXPORTERS[name] = fn
        return fn
    return register


def _common(unit):
    """The unit's weights and bias (and extra parameters), float32 in
    the JAX layout, in that order."""
    return {k: numpy.asarray(v, numpy.float32) for k, v in to_jax_layout(
        layer_params(unit.module)).items()}


@exporter("All2All", "All2AllTanh", "All2AllRELU", "All2AllStrictRELU",
          "All2AllSigmoid")
def _export_all2all(unit):
    data = _common(unit)
    data["activation"] = unit.module.activation_name
    data["output_sample_shape"] = list(unit.module.output_sample_shape)
    return data


@exporter("All2AllSoftmax")
def _export_softmax(unit):
    data = _common(unit)
    data["activation"] = "softmax"
    data["output_sample_shape"] = list(unit.module.output_sample_shape)
    return data


@exporter("Conv", "ConvTanh", "ConvRELU", "ConvStrictRELU", "ConvSigmoid")
def _export_conv(unit):
    module = unit.module
    data = _common(unit)
    if module.activation_name not in _CONV_ACTIVATIONS:
        raise NotImplementedError(
            "Conv activation %r is not supported by the native runtime"
            % module.activation_name)
    data["activation"] = module.activation_name
    data["n_kernels"] = module.n_kernels
    data["kx"], data["ky"] = module.kx, module.ky
    data["sliding"] = list(module.sliding)
    if isinstance(module.padding, str):
        data["padding"] = module.padding
    else:
        pad_h, pad_w = module.pad
        data["padding"] = [pad_w, pad_h, pad_w, pad_h]  # l, t, r, b
    return data


@exporter("MaxPooling", "MaxAbsPooling", "AvgPooling")
def _export_pooling(unit):
    module = unit.module
    return {"kx": module.kx, "ky": module.ky,
            "sliding": list(module.sliding)}


@exporter("LRNormalizerForward")
def _export_lrn(unit):
    module = unit.module
    return {"k": module.k, "alpha": module.alpha, "beta": module.beta,
            "n": module.n}


@exporter("ActivationUnit")
def _export_activation(unit):
    return {"activation": unit.module.activation_name}


@exporter("DropoutForward")
def _export_dropout(unit):
    return {"identity": True}  # inverted dropout serves as the identity


@exporter("MoEForward")
def _export_moe(unit):
    module = unit.module
    data = _common(unit)  # the router as "weights", then up and down
    data["n_experts"] = int(module.n_experts)
    data["capacity_factor"] = float(module.capacity_factor)
    data["residual"] = int(bool(module.residual))
    return data


@exporter("MultiHeadAttentionForward")
def _export_attention(unit):
    module = unit.module
    data = _common(unit)  # weights (4, D, D) and bias (4, D)
    data["heads"] = int(module.heads)
    # booleans as 0/1: the native JSON reader's numeric accessor
    data["causal"] = int(bool(module.causal))
    data["residual"] = int(bool(module.residual))
    return data


class _MemberWriter(object):
    """Names ``@NNNN_shape`` members and keeps their ``.npy`` bytes."""

    def __init__(self, precision):
        self.members = {}
        self.dtype = numpy.dtype(precision)

    def ref(self, array):
        array = numpy.ascontiguousarray(array, self.dtype)
        name = "@%04d_%s" % (len(self.members),
                             "x".join(str(d) for d in array.shape))
        buf = io.BytesIO()
        numpy.save(buf, array, allow_pickle=False)
        self.members[name] = buf.getvalue()
        return name


def _unit_entry(unit, writer):
    cls_name = type(unit).__name__
    export_fn = _EXPORTERS.get(cls_name)
    if export_fn is None:
        raise NotImplementedError(
            "%s is not exportable (supported: %s)" %
            (cls_name, sorted(_EXPORTERS)))
    data = export_fn(unit)
    for key, value in list(data.items()):
        if isinstance(value, numpy.ndarray):
            data[key] = writer.ref(value)
    return {"class": {"name": cls_name,
                      "uuid": getattr(type(unit), "__id__", None)},
            "data": data}


def export_workflow(workflow, path, precision="float32"):
    """Write the inference package of ``workflow``'s initialized forward
    chain to ``path``: one tar when it ends in ``.tar``, else a
    directory. Returns ``path``."""
    forwards = getattr(workflow, "forwards", None)
    if not forwards:
        raise ValueError("workflow has no forwards chain to export")
    writer = _MemberWriter(precision)
    units = [_unit_entry(unit, writer) for unit in forwards]
    loader = getattr(workflow, "loader", None)
    data = None if loader is None else getattr(loader, "minibatch_data",
                                               None)
    input_shape = None if data is None else list(data.shape)
    contents = {
        "workflow": {"name": workflow.name, "checksum": workflow.checksum,
                     "units": units},
        "input_shape": input_shape,
        "precision": str(numpy.dtype(precision)),
        "format_version": 1,
    }
    members = dict(writer.members)
    members["contents.json"] = json.dumps(
        contents, indent=2, sort_keys=True).encode("utf-8")

    def on_disk(name):
        return name + ".npy" if name.startswith("@") else name

    if str(path).endswith(".tar"):
        with tarfile.open(path, "w") as tar:
            for name in sorted(members):
                info = tarfile.TarInfo(on_disk(name))
                info.size = len(members[name])
                tar.addfile(info, io.BytesIO(members[name]))
    else:
        os.makedirs(path, exist_ok=True)
        for name, blob in members.items():
            with open(os.path.join(path, on_disk(name)), "wb") as f:
                f.write(blob)
    return path


def load_package_info(path):
    """(contents.json, sorted member names) of a package."""
    if os.path.isdir(path):
        with open(os.path.join(path, "contents.json"), "rb") as f:
            contents = json.loads(f.read())
        members = sorted(os.listdir(path))
    else:
        with tarfile.open(path, "r") as tar:
            members = sorted(tar.getnames())
            contents = json.loads(tar.extractfile("contents.json").read())
    return contents, members
