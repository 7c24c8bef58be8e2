"""The reference's examples on the port (counterparts of ``examples/*.py``).

Each module has a ``main()`` and runs as ``python -m
stillleben_tpu_torch.examples.<name>``, on the card unless ``--device cpu``
is given. Images are written with the port's own encoders.
"""
