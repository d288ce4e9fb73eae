"""Dry-run cells of the smoke configs on a fake 2x2 mesh, for
``test_torch_analysis.py``, which starts several of these at once:

    python _torch_dryrun_children.py OUT_DIR arch:shape [arch:shape ...]

Each cell goes through ``launch.dryrun.run_cell``, its config the smoke
one, on one fake 4-rank process group (this process is rank 0) and leaves
its record in OUT_DIR. Imports the port only.
"""

import sys
from pathlib import Path

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config
from repro_torch.launch import dryrun


def main(out: str, cells: list) -> int:
    dryrun.get_config = lambda name: get_config(name, smoke=True)
    with dryrun.fake_group(4):
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        for cell in cells:
            arch, shape = cell.split(":")
            dryrun.run_cell(arch, shape, "2x2", Path(out), mesh=mesh,
                            verbose=False)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2:]))
