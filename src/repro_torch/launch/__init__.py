"""repro_torch.launch — drivers.

``python -m repro_torch.launch.matserve`` drives mixed matrix-function
traffic through the bucketing engine (``repro_torch.serve.matfn``). The
reference's mesh, dry-run, train and LM-serve drivers come with the LM
substrate.
"""
