"""The port's counterparts of the repo's ``examples/``: the paper's own
ResNet-20 pipeline and the LM examples, each a ``main`` that runs on the
CUDA card unless it is given ``device="cpu"``.

    PYTHONPATH=src python -m repro_torch.examples.resnet20_bsq_paper
    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
