"""repro_torch.launch — drivers.

``python -m repro_torch.launch.matserve`` drives mixed matrix-function
traffic through the bucketing engine (``repro_torch.serve.matfn``);
``python -m repro_torch.launch.serve`` generates text with the LM engine
(``repro_torch.serve.engine``); ``python -m repro_torch.launch.train``
trains an LM (data -> train step -> checkpoint); ``launch.mesh`` builds
the production meshes; ``python -m repro_torch.launch.dryrun`` counts every
(arch x shape x mesh) cell of them from shapes alone (meta tensors on a
fake process group) and sets the counts against the H100's roofline.
"""
