"""repro_torch.launch — drivers.

``python -m repro_torch.launch.matserve`` drives mixed matrix-function
traffic through the bucketing engine (``repro_torch.serve.matfn``);
``python -m repro_torch.launch.serve`` generates text with the LM engine
(``repro_torch.serve.engine``). The reference's mesh, dry-run and train
drivers come with the training slice.
"""
