"""The plain reference: straightforward PyTorch in float32 (TF32 off),
written from the architecture's equations, importing nothing of the
program under test and nothing of the JAX package.  It takes the float
weights and the inputs the benchmark made, and works out everything the
program derives from them (6-bit codes and scales, BSQ planes) anew."""
