"""The paper's benchmark suite as GCV-Turbo layer graphs.

Port of ``src/repro/gnncv/__init__.py``.

  tasks.py    b1-b6 GNN-based CV tasks (Table III/IV)
  cnn_zoo.py  c1-c5 CNNs (scope 1)
  gnn_zoo.py  g1-g3 GNNs (scope 2)
  graphs.py   synthetic graph generators with the published statistics
"""
from repro_torch.gnncv.cnn_zoo import CNN_ZOO          # noqa: F401
from repro_torch.gnncv.gnn_zoo import GNN_ZOO          # noqa: F401
from repro_torch.gnncv.tasks import TASKS              # noqa: F401
