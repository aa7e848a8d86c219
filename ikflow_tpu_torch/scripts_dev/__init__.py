"""The artifact tools of the JAX package's ``scripts_dev/``, on the port:
one module per script, under the same names, each with the script's
arguments, lines and exit codes, and ``main(argv=None) -> int``:

- ``stamp_warm_start``: warm-start provenance added to an exported artifact's
  header (it runs no flow: it takes no ``--device``);
- ``convert_softflow_init``: a softflow artifact as the warm start of a
  sigmoid-head model without softflow, checked against its source;
- ``grow_flow_init``: an N-block artifact grown to M blocks by identity
  couplings, its NLL checked against its source's;
- ``export_from_checkpoint``: the deploy artifact of a ``train`` run's newest
  checkpoint (the port's ``torch.save`` files), graded by the run's
  ``metrics.jsonl`` and gated;
- ``stamp_quality_headers``: a shipped artifact's quality re-measured with
  ``Trainer.validate`` and written into its header.

Run one with ``python -m ikflow_tpu_torch.scripts_dev.<name> [arguments]``.
The tools that run the flow take ``--device`` (default ``cuda``, which
raises without a card; ``cpu`` runs on the CPU). On a card the flow's
inverse runs the subnet kernels (K1, or K1' with ``bf16_hidden``). The
artifact format is ``training/checkpoints.py``'s (``read_artifact``,
``write_artifact``).
"""
