"""The reference's own pieces: the frozen Philox copy against the
port's plain fill, the precisions, and (on a card) the control
separated from the cell's precision."""

import pytest
import torch

from conftest import tiny_cell
from portbench import checks
from portbench.drivers import train
from portbench.reference import model as reference
from portbench.reference import philox


@pytest.mark.parametrize("shape,seed,batch,layer", [
    ((16, 32), 0x0123456789ABCDEF, 0, 11), ((3, 7, 5), 2 ** 63 + 5, 9, 13),
    ((128, 4096), 7, 127, 13)])
def test_philox_copy_matches_the_port(shape, seed, batch, layer):
    from veles_tpu_torch.ops.random import dropout_uniforms
    ours = philox.uniforms(shape, seed, batch, layer, "cpu")
    port = dropout_uniforms(shape, seed, batch, layer, torch.device("cpu"),
                            plain=True)
    assert torch.equal(ours, port)


def test_epoch_seed_matches_the_port():
    from veles_tpu_torch import prng
    gen = prng.RandomGenerator("test").seed(0xDEADBEEF12)
    assert philox.epoch_seed(0xDEADBEEF12, 0) == gen.philox_seed()
    assert philox.epoch_seed(0xDEADBEEF12, 1) == gen.philox_seed()


def test_reference_imports_nothing_of_the_program():
    import ast
    import os
    base = os.path.dirname(reference.__file__)
    for name in os.listdir(base):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(base, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("torch", "math", "contextlib",
                                             "numpy", "portbench"), (
                    name, mod)
                if mod.startswith("portbench"):
                    assert mod == "portbench.reference", (name, mod)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_control_is_separated_on_the_card(card, policy):
    """On the card the control (TF32 for float32, float8 operands for
    bfloat16) reads the first gradient far further from the reference
    than the port's sound run does, at a size a test run holds."""
    cell = tiny_cell(policy, dtype="bfloat16")
    cell.config["sample_shape"] = [67, 67, 3]
    cell.config["layers"][5]["output_sample_shape"] = 512
    cell.config["minibatch"] = 64
    cell.config["data"].update(n_train=256, n_valid=64)
    precision, control = reference.POLICY_PRECISION[policy]
    names = ("grad_gap", "out_grad_gap")
    sound, low = [], []
    for seed in (1, 2, 3):
        sound.append(train.compare(train.first_steps(cell, seed, card)))
        ref = train.reference_steps(cell, seed, card, precision)
        low.append(checks.numbers(train.reference_steps(
            cell, seed, card, control), ref))
    separated = {n: min(v[n] for v in low) /
                 max(max(v[n] for v in sound), 1e-30) for n in names}
    assert max(separated.values()) > 3, (sound, low)
