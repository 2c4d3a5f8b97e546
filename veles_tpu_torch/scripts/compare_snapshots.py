"""Compare two workflow snapshots array by array
(``veles_tpu/scripts/compare_snapshots.py``).

    python -m veles_tpu_torch.scripts.compare_snapshots [-q] \\
        [-s dep|unit|attr|avgreldiff|avgdiff|maxdiff ...] FIRST SECOND

Loads both snapshots (the port's, or the JAX package's through
:mod:`veles_tpu_torch.jax_snapshot`: a file, a snapshot directory,
``http(s)://`` or ``sqlite://``), walks their units in dependency order,
diffs every array a unit holds and prints a sortable table of the
average relative, average and largest absolute differences. A unit's
arrays are the numpy arrays and tensors among its attributes and inside
its dicts and lists, each under its key: a forward unit's parameters
(its ``weights`` and ``bias`` in the JAX layout) and a gradient unit's
solver state.
"""

import argparse
import logging
import sys

import numpy

SORT_CHOICES = ("dep", "unit", "attr", "avgreldiff", "avgdiff", "maxdiff")
SORT_CHOICES_MAP = {k: i for i, k in enumerate(SORT_CHOICES)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Compare snapshots")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="do not print logs")
    parser.add_argument("-s", "--sort", choices=SORT_CHOICES, nargs="*",
                        default=["dep", "avgreldiff"],
                        help="sort by these fields, in order")
    parser.add_argument("first", help="path to the first snapshot")
    parser.add_argument("second", help="path to the second snapshot")
    return parser.parse_args(argv)


def load_snapshot(path):
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    return SnapshotterToFile.import_(path)


def _host(value):
    """A numpy array or tensor as a float64 numpy array, else None (a
    meta tensor, whose shape alone a snapshot keeps, too)."""
    if isinstance(value, numpy.ndarray):
        return numpy.atleast_1d(value.astype(numpy.float64))
    detach = getattr(value, "detach", None)
    if detach is not None and getattr(value, "is_meta", True) is False:
        return numpy.atleast_1d(detach().cpu().double().numpy())
    return None


def _flatten(name, value, out):
    """Every array of ``value`` (an array, or dicts and lists of them)
    into ``out`` under ``name`` and its keys joined by dots."""
    if isinstance(value, dict):
        for key in sorted(value, key=str):
            _flatten("%s.%s" % (name, key) if name else str(key),
                     value[key], out)
    elif isinstance(value, (list, tuple)):
        for i, item in enumerate(value):
            _flatten("%s.%d" % (name, i), item, out)
    else:
        host = _host(value)
        if host is not None:
            out[name] = host


def unit_arrays(unit):
    """``{attribute: float64 array}`` of one restored unit: its array
    attributes, and the arrays inside its dict and list attributes under
    their keys (a forward unit's ``_params`` give ``weights`` and
    ``bias``)."""
    arrays = {}
    for key, value in sorted(unit.__dict__.items()):
        _flatten("" if key == "_params" else key.strip("_"), value, arrays)
    return arrays


def get_diffs(first_units, second_units):
    """Yield (dep_index, unit, attr, avgreldiff, avgdiff, maxdiff)."""
    for index, (first_unit, second_unit) in enumerate(
            zip(first_units, second_units)):
        second = unit_arrays(second_unit)
        for key, a in unit_arrays(first_unit).items():
            b = second.get(key)
            if b is None:
                continue
            if a.shape != b.shape:
                yield (index, first_unit.name, key,
                       float("inf"), float("inf"), float("inf"))
                continue
            diff = a - b
            avg_diff = float(numpy.mean(numpy.abs(diff))) if diff.size \
                else 0.0
            val_sum = a + b
            nz = numpy.nonzero(val_sum)
            rel = 2 * (diff[nz] / val_sum[nz])
            if rel.size > 0:
                avg_rel_diff = float(numpy.mean(numpy.abs(rel)))
            else:
                avg_rel_diff = float(not (diff == 0).all())
            max_diff = float(numpy.max(numpy.abs(diff))) if diff.size \
                else 0.0
            yield (index, first_unit.name, key,
                   avg_rel_diff, avg_diff, max_diff)


def sort_diffs(diffs, sorting):
    return sorted(diffs, key=lambda rec: tuple(
        rec[SORT_CHOICES_MAP[sk]] for sk in sorting))


def format_table(diffs):
    """A plain-text table of the differences."""
    headers = ("Unit", "Attribute", "Avg Rel Diff", "Avg Diff", "Max Diff")
    rows = [(name, attr, "%.6g" % rel, "%.6g" % avg, "%.6g" % mx)
            for _, name, attr, rel, avg, mx in diffs]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    sep = "+-" + "-+-".join("-" * w for w in widths) + "-+"
    out = [sep, "| " + " | ".join(
        h.ljust(w) for h, w in zip(headers, widths)) + " |", sep]
    for row in rows:
        out.append("| " + " | ".join(
            c.ljust(w) for c, w in zip(row, widths)) + " |")
    out.append(sep)
    return "\n".join(out)


def compare(first_path, second_path, sorting=("dep", "avgreldiff")):
    first = load_snapshot(first_path)
    second = load_snapshot(second_path)
    if type(first) is not type(second) or \
            first.checksum != second.checksum:
        raise ValueError("Cannot compare different workflows")
    return sort_diffs(get_diffs(first.units_in_dependency_order,
                                second.units_in_dependency_order), sorting)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.WARNING if args.quiet else logging.INFO)
    diffs = compare(args.first, args.second, args.sort)
    print(format_table(diffs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
