"""Fault tolerance (``cgnn_tpu/resilience``): so far the integrity
manifests that commit and verify the port's checkpoints. The divergence
guard, preemption and fault injection are not ported yet."""
