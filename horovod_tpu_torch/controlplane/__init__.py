"""The coordinator's pod-scale control plane.

Counterpart of horovod_tpu/controlplane/, with its three pieces:

- :mod:`~horovod_tpu_torch.controlplane.simrank` — a simulated-rank
  harness: hundreds of lightweight negotiation clients speaking the real
  protocol over the real :mod:`~horovod_tpu_torch.utils.kvstore` TCP
  service against a live coordinator, no device. Measures rounds a
  second, decision-latency percentiles and per-key KV hot spots; the
  resnet bench's ``control_plane`` row is its curve.
- :mod:`~horovod_tpu_torch.controlplane.aggregate` — tree fan-in: group
  heads batch their group's request (and, under elastic, liveness and
  goodbye) blobs into ONE packed KV write, so the root reads
  O(fanout + world/fanout) keys per round instead of O(world); under
  elastic a head whose blob stops moving has its group read directly.
  Knob: ``HOROVOD_COORD_TREE_FANOUT``.
- :mod:`~horovod_tpu_torch.controlplane.schedule` — static-schedule
  graduation: after K identical negotiation rounds a steady-state
  pending set graduates to a negotiation-free fixed schedule. Knob:
  ``HOROVOD_COORD_GRADUATE_AFTER``.
"""
