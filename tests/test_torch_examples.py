"""The port's examples (``examples/torch_example.py``,
``examples/torch_fleet_serving.py``) run end to end on the CPU at a small
size, with the shipped weights of the registry's default model (full width:
two intra-op threads, so the suite's other workers keep their cores)."""

import importlib.util
import os

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")


@pytest.fixture
def two_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _main(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def test_torch_example_runs(capsys, two_threads):
    assert _main("torch_example")(["--device", "cpu", "--uninitialized"]) == 0
    out = capsys.readouterr().out
    for line in ("5 solutions for a single pose (robot: panda)", "batched: 8 solutions for 8 poses", "exact IK: ",
                 "diverse sampling: mean pairwise spread"):
        assert line in out


def test_torch_fleet_serving_runs(capsys, two_threads):
    assert _main("torch_fleet_serving")(["--device", "cpu", "--uninitialized", "--devices", "cpu,cpu", "--n", "8",
                                         "--mega_n", "24", "--chunk_size", "8"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 2 entries" in out and "sharded solve: 8 poses" in out and "megabatch: 24 poses" in out
    assert "the mechanics, not scaling" in out
    assert "1 device(s):" in out and "2 device(s):" in out


def test_examples_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("torch_example", "torch_fleet_serving"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _main(name)(["--uninitialized"])
