"""The port's command-line entry points run on the GPU unless asked for the
CPU: without CUDA they raise, naming ``--device cpu``, and with it they run.
"""

import pytest
import torch

from miniweatherml_tpu_torch.experiments import (community_benchmark,
                                                 simple_city,
                                                 supercell_example,
                                                 supercell_p3)

SUPERCELL = ("nx_glob: 12\nny_glob: 2\nnz: 12\nxlen: 40000.0\n"
             "ylen: 40000.0\nzlen: 16000.0\ninit_data: supercell\n"
             "out_freq: -1.0\nsim_time: 2.0\n")
BUILDING = ("nx_glob: 24\nny_glob: 16\nnz: 10\nxlen: 2000.0\nylen: 2000.0\n"
            "zlen: 500.0\ninit_data: building\nout_freq: -1.0\n"
            "enable_gravity: false\nsim_time: 0.05\n")

MAINS = {"supercell_example": (supercell_example.main, SUPERCELL),
         "supercell_p3": (supercell_p3.main, SUPERCELL),
         "simple_city": (simple_city.main, BUILDING),
         "community_benchmark": (community_benchmark.main, SUPERCELL)}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_entry_point_needs_cuda_unless_asked_for_cpu(name, tmp_path,
                                                     monkeypatch):
    main, yaml = MAINS[name]
    path = tmp_path / "input.yaml"
    path.write_text(yaml + f"out_prefix: {tmp_path / 'out'}\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([str(path)])
    out = main([str(path), "--device", "cpu"])
    state = out[0] if isinstance(out, tuple) else out
    assert state.device.type == "cpu"
    assert state.validate() == {}
