"""Plain float32 PyTorch reference of the benchmark's training cells.

Independent of the program: it imports nothing of ``repro_torch``, of the
JAX package ``repro`` or of JAX. ``weights`` and ``tokens`` are the frozen
generators of the inputs that the benchmark hands to both sides; ``model``
is the forward and loss of the dense and MoE families; ``step`` the train
step (autograd backward, global-norm clip, AdamW).
"""
