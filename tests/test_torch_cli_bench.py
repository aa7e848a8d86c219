"""``ikflow-torch benchmark`` on the CPU (``--device cpu``) against the JAX
package's ``ikflow-tpu benchmark`` on the same arguments: each row's JSON
keys, the four ``--compare`` methods, the megabatch legs, the depth sweep
and the ``--scaling`` rows. Both packages' default architecture is
swapped for the tiny flow (``tiny_default``)."""

import json

import pytest

from ikflow_tpu_torch.cli.main import main
from test_torch_cli import _both, tiny_default  # noqa: F401  (a fixture)


def _keys_plain(out):
    return [sorted(row) for row in map(json.loads, out.strip().splitlines())]


def _keys(out):
    return [(row["mode"], sorted(row)) for row in map(json.loads, out.strip().splitlines())]


@pytest.mark.parametrize("extra", [["--mode", "both"], ["--mode", "both", "--capacity", "full"], ["--compare"]],
                         ids=["both", "full", "compare"])
def test_benchmark_rows_have_jax_keys(capsys, tiny_default, extra):
    port, jax_out = _both(capsys, ["benchmark", "--robot_name", "panda", "--batch_sizes", "4", "--k", "1",
                                   "--uninitialized", "--n_opt_steps_max", "1"] + extra)
    assert _keys(port) == _keys(jax_out)
    if extra == ["--compare"]:
        assert [m for m, _ in _keys(port)] == ["flow_approx", "flow_plus_lm_exact", "native_lm_random_seed",
                                               "native_lm_flow_seeded"]


def test_benchmark_megabatch_and_sweep_rows(capsys, tiny_default):
    argv = ["benchmark", "--robot_name", "panda", "--megabatch", "40", "--chunk_size", "16", "--steady_chunk", "32",
            "--n_opt_steps_max", "1", "--repeat_counts", "1", "2", "--uninitialized"]
    port, jax_out = _both(capsys, argv)
    assert _keys(port.splitlines()[-1]) == _keys(jax_out.splitlines()[-1])
    assert "megabatch:" in port  # the cold leg reports its progress
    assert main(["benchmark", "--robot_name", "panda", "--sweep_nb_nodes", "1", "2", "--device", "cpu"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [(r["mode"], r["nb_nodes"]) for r in rows] == [("nb_nodes_sweep", 1), ("nb_nodes_sweep", 2)]
    # --scaling: the JAX package's rows (1 and 8 virtual devices) and the
    # port's (1 and 1: the CPU) have the same keys; the port's are finite.
    argv = ["benchmark", "--robot_name", "panda", "--scaling", "--batch_sizes", "8", "--n_opt_steps_max", "1",
            "--repeat_counts", "1", "--uninitialized"]
    port, jax_out = _both(capsys, argv)
    assert _keys_plain(port) == _keys_plain(jax_out)
    rows = [json.loads(x) for x in port.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 1]
    assert all(r["sols_per_s"] > 0 and r["seconds"] > 0 and r["efficiency"] > 0 for r in rows)
