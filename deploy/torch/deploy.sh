#!/bin/sh
# Bootstrap of the PyTorch/CUDA port (veles_tpu_torch) on a CUDA host:
# install the package from this tree without its dependencies (the host
# brings torch, numpy and scipy; nothing is downloaded), prebuild its
# CUDA kernels from the installed copy's sources, build the native
# runtime where the tree has one, and, with --systemd, install the
# services' units.
#
#   deploy/torch/deploy.sh [--target DIR] [--systemd]
#
# PYTHON names the interpreter (python3). --target DIR installs into DIR
# (pip's --target: put DIR on PYTHONPATH and DIR/bin on PATH to run it)
# instead of the interpreter's site-packages.
set -e

PYTHON=${PYTHON:-python3}
TREE=$(cd "$(dirname "$0")/../.." && pwd)
TARGET=
SYSTEMD=0
while [ $# -gt 0 ]; do
    case "$1" in
        --target) TARGET=$2; shift 2 ;;
        --systemd) SYSTEMD=1; shift ;;
        *) echo "usage: $0 [--target DIR] [--systemd]" >&2; exit 2 ;;
    esac
done

cd "$TREE"
PIP="$PYTHON -m pip install --no-deps --no-build-isolation --no-index --no-cache-dir --disable-pip-version-check"
if [ -n "$TARGET" ]; then
    $PIP --target "$TARGET" .
    PYTHONPATH="$TARGET${PYTHONPATH:+:$PYTHONPATH}"
    export PYTHONPATH
else
    $PIP .
fi

# the kernels, built from the installed copy's csrc/ into its csrc/build/
# (or the per-user cache): from a directory outside the tree, since -m
# imports the working directory first
OUTSIDE=$(mktemp -d)
(cd "$OUTSIDE" && $PYTHON -m veles_tpu_torch.ops.build)
rmdir "$OUTSIDE"

# the native runtime, from the tree as the JAX package's bootstrap does
if [ -d native ]; then
    $PYTHON -c "from veles_tpu_torch.export.native import build_native; build_native()"
fi

if [ "$SYSTEMD" = 1 ]; then
    if [ ! -d /etc/systemd/system ] || [ "$(id -u)" != 0 ]; then
        echo "--systemd needs root and /etc/systemd/system" >&2
        exit 1
    fi
    id veles >/dev/null 2>&1 || useradd -r -s /usr/sbin/nologin veles
    install -d -o veles -g veles /var/lib/veles-tpu-torch/forge
    install -m 644 deploy/torch/systemd/veles-tpu-torch-forge.service \
        deploy/torch/systemd/veles-tpu-torch-web-status.service \
        /etc/systemd/system/
    systemctl daemon-reload
    echo "enable with: systemctl enable --now veles-tpu-torch-forge veles-tpu-torch-web-status"
fi
echo "done."
