"""Job computation graphs (copy of ``ddls_tpu/graphs``)."""
from ddls_tpu_torch.graphs.op_graph import OpGraph
from ddls_tpu_torch.graphs.readers import (
    graph_from_pbtxt,
    graph_from_pipedream_txt,
)
from ddls_tpu_torch.graphs.synthetic import generate_pipedream_txt_files

__all__ = [
    "OpGraph",
    "graph_from_pipedream_txt",
    "graph_from_pbtxt",
    "generate_pipedream_txt_files",
]
