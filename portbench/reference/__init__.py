"""Plain PyTorch reference of one span of the batched GrainGNN rollout.

It imports nothing of graingraphnn_torch (nor JAX). From the state a span
starts from it builds the sample again (graph.py), runs both models'
forwards (model.py, weights read from the checkpoint files by
weights.py), and runs the post-forward stages of one lane (span.py, with
the topology editor of editor.py). precision.py holds the roundings that
the configurations state (fp32, bf16) and those of the controls below
them (TF32, fp8).
"""
