"""Fault tolerance (``cgnn_tpu/resilience``), four layers:

- ``integrity``: per-leaf shape, dtype and crc32 manifests, the commit
  marker and verification of the crash-safe checkpoints
  (train/checkpoint.py);
- ``preempt``: SIGTERM or SIGINT -> a checkpoint at the next epoch
  boundary (the next chunk boundary under the epoch driver) -> exit
  ``RESUMABLE_EXIT_CODE`` (75), for a scheduler to requeue with
  ``--resume auto``;
- ``guard``: the divergence guard, a select of old against new state
  inside the replayed train graph (bit-equal when nothing fires; in a
  data-parallel step after the collective, so every rank skips alike),
  and ``DivergenceMonitor``, which rolls back to the last good
  checkpoint with a cut rate after too many skipped steps;
- ``faultinject``: deterministic, environment-gated faults for the
  layers above (NaN batches, loader failures, a SIGTERM at an epoch's
  end, crashes at the checkpoint finalizer's points, corrupted saves)
  and for the server (failed, wedged and slow dispatches, dropped
  connections, boot crashes, a preemption mid-load).

Not ported: the continual trainer's ``label_noise`` hook (ROADMAP Queue
1, item 12)."""
