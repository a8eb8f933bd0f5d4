"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
wrappers, their plain PyTorch versions (:mod:`.ref`) and the entry
points that pick between them by device (:mod:`.ops`).  Importing this
package builds nothing; a kernel is compiled at its first launch."""
