"""One rank of the two-process check of the data-parallel step on the
graphs in ``tests/test_torch_mesh_graphs.py``: joins a gloo process group
through ``initialize_multihost`` (torchrun's environment markers, set by the
test), trains ``fit_on_device`` of the tiny flow on a two-entry CPU mesh
for ``STEPS`` steps eagerly, then again with its programs through a
stub-backed cache (``StepStub``: the capture's run stands for the replay
after it), and saves both runs' parameters and losses to ``argv[1]``."""

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

from ikflow_tpu_torch.graphs import GraphCache  # noqa: E402
from ikflow_tpu_torch.parallel.mesh import initialize_multihost, make_mesh  # noqa: E402
from ikflow_tpu_torch.robots import get_robot  # noqa: E402
from ikflow_tpu_torch.training import TrainConfig, Trainer  # noqa: E402
from ikflow_tpu_torch.training.common import tree_leaves  # noqa: E402
from test_torch_training_graphs import StepStub, _dataset, _flow  # noqa: E402

BATCH, STEPS = 32, 5


def run(graphs: bool):
    """-> (parameter leaves, window losses, captures) of one run."""
    flow, params = _flow()
    caches = []

    def new_graphs(trainer):
        caches.append(GraphCache(trainer.device, backend=StepStub()))
        return caches[-1]

    seen = []
    trainer = Trainer(flow, get_robot("panda"), TrainConfig(batch_size=BATCH, n_steps=STEPS, log_every=1,
                                                            eval_every=0, checkpoint_every=0),
                      metric_hook=lambda s, m: seen.append(m["tr/loss"]), device="cpu",
                      mesh=make_mesh([torch.device("cpu")] * 2))
    if graphs:
        trainer._new_graphs = lambda: new_graphs(trainer)
    trained, _ = trainer.fit_on_device(params, _dataset(), steps_per_call=1)
    return [t.clone() for t in tree_leaves(trained)], seen, sum(c.captures for c in caches)


if __name__ == "__main__":
    initialize_multihost()
    eager, eager_losses, _ = run(False)
    graph, graph_losses, captures = run(True)
    torch.save({"eager": eager, "graph": graph, "eager_losses": eager_losses, "graph_losses": graph_losses,
                "captures": captures, "rank": torch.distributed.get_rank()}, sys.argv[1])
    torch.distributed.destroy_process_group()
