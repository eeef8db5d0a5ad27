"""Fused per-lane device loops (ops/lane_loop.py): each runs as a
Pallas-Triton kernel or as its plain XLA twin.  See step_kernel.py for
the rollouts and learner_kernel.py for the training chunks.
"""
