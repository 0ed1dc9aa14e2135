"""The coordinator's pod-scale control plane.

Counterpart of horovod_tpu/controlplane/, carrying two of its three
pieces:

- :mod:`~horovod_tpu_torch.controlplane.aggregate` — tree fan-in: group
  heads batch their group's request blobs into ONE packed KV write, so
  the root reads O(fanout + world/fanout) keys per round instead of
  O(world). Knob: ``HOROVOD_COORD_TREE_FANOUT``.
- :mod:`~horovod_tpu_torch.controlplane.schedule` — static-schedule
  graduation: after K identical negotiation rounds a steady-state
  pending set graduates to a negotiation-free fixed schedule. Knob:
  ``HOROVOD_COORD_GRADUATE_AFTER``.

The simulated-rank harness (``simrank``) waits in ROADMAP.md, Queue 1
item 10.
"""
