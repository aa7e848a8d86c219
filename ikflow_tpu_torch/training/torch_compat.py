"""Migration bridge from the reference implementation's (jstmn/ikflow) files.

Port of ``ikflow_tpu/training/torch_compat.py``:

1. ``import_reference_state_dict`` maps a FrEIA ``GraphINN`` state dict (the
   reference's deploy pickle, with the ``nn_model.`` prefix stripped) onto
   the port's parameters. FrEIA's keys for GLOW coupling blocks are
   ``module_list.<node>.subnet{1,2}.<seq>.{weight,bias}`` (the Sequential
   indices skip the LeakyReLU layers); ``torch.nn.Linear`` stores its weight
   as (out, in), the port as (in, out).
2. ``load_reference_dataset`` reads the reference's directory of four
   ``.pt`` tensors into an ``IkDataset``.

The architecture must match: depth, widths and split sizes are checked
layer by layer against the template's shapes. The port's permutations are
``Fm.PermuteRandom(seed=i)``'s and its input head is rebuilt from the
robot's joint limits, so only the subnet weights are imported; permutation
buffers, where the state dict has them, are checked against the flow's.
Exact parity with a reference model also needs its clamp activation
(``FlowHyperParams.clamp_activation``).
"""

from __future__ import annotations

import os
import pickle
import re
import zipfile
from typing import Dict, Union

import numpy as np
import torch

from ikflow_tpu_torch.flow.model import GlowFlow
from ikflow_tpu_torch.training.dataset import IkDataset

_SUBNET_KEY = re.compile(r"^module_list\.(\d+)\.subnet([12])\.(\d+)\.(weight|bias)$")
_PERM_KEY = re.compile(r"^module_list\.(\d+)\.(perm|perm_inv|w_perm|w_perm_inv)$")


def _to_tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def load_reference_pickle(path: str) -> Dict[str, torch.Tensor]:
    """A reference deploy file: a state dict of tensors written by
    ``torch.save`` (read with ``weights_only=True``) or by ``pickle.dump``."""
    if zipfile.is_zipfile(path):
        state = torch.load(path, map_location="cpu", weights_only=True)
    else:
        with open(path, "rb") as f:
            state = pickle.load(f)
    return {k: _to_tensor(v) for k, v in state.items()}


def import_reference_state_dict(state: Union[str, Dict], flow: GlowFlow, params_template):
    """A FrEIA GraphINN state dict (or the path of one) as the flow's
    parameters, on the device and in the dtype of ``params_template`` (from
    ``flow.init``, which gives the structure and the expected shapes).
    Raises with a precise message on any architecture mismatch."""
    if isinstance(state, str):
        state = load_reference_pickle(state)
    state = {k: _to_tensor(v) for k, v in state.items()}

    # node -> subnet ("1" | "2") -> Sequential index -> {"weight", "bias"}
    nodes: Dict[int, Dict[str, Dict[int, Dict[str, torch.Tensor]]]] = {}
    for k, v in state.items():
        m = _SUBNET_KEY.match(k)
        if m:
            node, sub, seq, kind = int(m.group(1)), m.group(2), int(m.group(3)), m.group(4)
            nodes.setdefault(node, {}).setdefault(sub, {}).setdefault(seq, {})[kind] = v
    if not nodes:
        raise ValueError(
            "no FrEIA coupling-subnet keys (module_list.N.subnetM.K.weight) found; "
            f"state dict keys look like: {list(state)[:5]}"
        )
    coupling_nodes = sorted(nodes)
    if len(coupling_nodes) != flow.hp.nb_nodes:
        raise ValueError(f"state dict has {len(coupling_nodes)} coupling blocks, flow has {flow.hp.nb_nodes}")

    perm_nodes: Dict[int, Dict[str, torch.Tensor]] = {}
    for k, v in state.items():
        m = _PERM_KEY.match(k)
        if m:
            perm_nodes.setdefault(int(m.group(1)), {})[m.group(2)] = v
    for i, node in enumerate(sorted(perm_nodes)):
        theirs = perm_nodes[node].get("perm")
        if theirs is None or theirs.ndim != 1:
            continue
        theirs = theirs.numpy().astype(np.int64)
        ours = flow._perms[i]
        if not np.array_equal(np.sort(theirs), np.arange(len(ours))):
            continue  # not an index vector
        if not np.array_equal(theirs, ours):
            raise ValueError(f"permutation mismatch at block {i}: reference {theirs}, ours {ours}")

    blocks = []
    for bi, node in enumerate(coupling_nodes):
        block = {}
        for sub, ours in (("1", "s1"), ("2", "s2")):
            seqs = nodes[node].get(sub)
            if seqs is None:
                raise ValueError(f"block {bi}: missing subnet{sub}")
            layers = [seqs[k] for k in sorted(seqs)]
            template = params_template[bi][ours]
            if len(layers) != len(template):
                raise ValueError(
                    f"block {bi} subnet{sub}: {len(layers)} linear layers in state dict, "
                    f"{len(template)} expected (depth mismatch?)"
                )
            out = []
            for li, (ref, tmpl) in enumerate(zip(layers, template)):
                w, b = ref["weight"].T, ref["bias"]  # torch (out, in) -> (in, out)
                if w.shape != tmpl["w"].shape or b.shape != tmpl["b"].shape:
                    raise ValueError(
                        f"block {bi} subnet{sub} layer {li}: shapes {tuple(w.shape)}/{tuple(b.shape)} "
                        f"vs expected {tuple(tmpl['w'].shape)}/{tuple(tmpl['b'].shape)}"
                    )
                out.append({"w": w.to(tmpl["w"].device, tmpl["w"].dtype).contiguous(),
                            "b": b.to(tmpl["b"].device, tmpl["b"].dtype).contiguous()})
            block[ours] = out
        blocks.append(block)
    return tuple(blocks)


def load_reference_dataset(directory: str, robot_name: str) -> IkDataset:
    """The reference's ``.pt`` dataset directory (``samples_tr``,
    ``endpoints_tr``, ``samples_te``, ``endpoints_te``) as an ``IkDataset`` of
    numpy arrays."""
    arrays = {}
    for name in ("samples_tr", "endpoints_tr", "samples_te", "endpoints_te"):
        path = os.path.join(directory, f"{name}.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        arrays[name] = torch.load(path, map_location="cpu", weights_only=True).numpy()
    return IkDataset(arrays["samples_tr"], arrays["endpoints_tr"], arrays["samples_te"], arrays["endpoints_te"],
                     robot_name)
