"""The repository's ``tools/`` scripts that are not TPU-only, on the port.

Each runs as ``python -m stillleben_tpu_torch.tools.<name>``, takes the
JAX script's arguments plus ``--device`` (default ``cuda``; no card is an
error) and prints the JAX script's lines:

- ``settle_fidelity``: the settle's resting-pose distribution under the
  solver configurations, against the reference schedule;
- ``display_mesh``: a turntable contact sheet of a mesh file;
- ``viewer_demo``: the scripted ``Viewer`` session;
- ``align_mesh``: ``.pretransform`` sidecars, batch or interactive.

``templates`` holds the bench's "textured" composition they share.
"""
