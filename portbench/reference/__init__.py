"""The plain reference the benchmark holds the port to.

Plain PyTorch, computed in blocks of rows on whatever device the inputs
are on, with TF32 never used unless asked for.  It imports nothing of
``repro_torch``, ``repro`` or ``jax``, and takes nothing the program made:
it works every result out again from the benchmark's own inputs.

``precision="tf32"`` computes the same algorithm with the inputs of every
product rounded to TF32 (10 mantissa bits, as the tensor cores round
float32 inputs): the control that a correctness check has to fail.
"""
