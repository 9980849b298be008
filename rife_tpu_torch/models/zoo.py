"""Model zoo: the shipped RIFE model directories and their loaders (copy of
``rife_tpu/models/zoo.py``).

Family sniffing mirrors the reference CLI: a path containing
``rife-v2``/``rife-v3`` selects the v2 engine path, ``rife-v4`` the v4
(single-net, timestep-conditioned) path, bare ``rife`` the v1 path.

Weights: real ``.bin`` files are used when present; absent streams fall back
to deterministic synthetic weights (``graph/weights.py``) — the graphs,
shapes and compute are identical either way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from ..graph.ir import Graph
from ..graph.param import parse_param
from ..graph.weights import LayerWeights, load_bin, synthesize_weights

# a model name that is not a directory is looked up here (relative to the
# working directory, as the reference CLI resolves ``-m`` beside itself)
DEFAULT_MODEL_ROOT = Path("models")

MODEL_NAMES = [
    "rife", "rife-HD", "rife-UHD", "rife-anime",
    "rife-v2", "rife-v2.3", "rife-v2.4",
    "rife-v3.0", "rife-v3.1",
    "rife-v4", "rife-v4.6",
]


def sniff_family(model_path: str) -> str:
    """'v1' | 'v2' | 'v4' from the model dir name (reference semantics:
    v3 models use the v2 engine path)."""
    name = str(model_path)
    if "rife-v2" in name or "rife-v3" in name:
        return "v2"
    if "rife-v4" in name:
        return "v4"
    if "rife" in name:
        return "v1"
    raise ValueError(f"unknown model dir type: {model_path!r}")


@dataclass
class LoadedNet:
    graph: Graph
    weights: Dict[str, LayerWeights]
    synthetic: bool


@dataclass
class LoadedModel:
    name: str
    family: str  # v1 | v2 | v4
    nets: Dict[str, LoadedNet] = field(default_factory=dict)

    @property
    def any_synthetic(self) -> bool:
        return any(n.synthetic for n in self.nets.values())


def resolve_model_dir(model: str, root: Optional[Path] = None) -> Path:
    """Use ``model`` as a path if it exists, else look it up under the zoo
    root."""
    p = Path(model)
    if p.is_dir():
        return p
    rooted = Path(root or DEFAULT_MODEL_ROOT) / model
    if rooted.is_dir():
        return rooted
    raise FileNotFoundError(f"model dir {model!r} not found (tried {p}, {rooted})")


def net_names_for_family(family: str) -> List[str]:
    # v4 loads the flownet only
    return ["flownet"] if family == "v4" else ["flownet", "contextnet", "fusionnet"]


def load_model(model: str, root: Optional[Path] = None,
               synth_mode: str = "mix") -> LoadedModel:
    """Parse the model dir's nets and bind their weights (``synth_mode``:
    the synthesis mode of absent ``.bin`` streams, ``synthesize_weights``)."""
    model_dir = resolve_model_dir(model, root)
    # sniff the FULL resolved path, as the CLI sniffs the user string
    family = sniff_family(str(model_dir))
    loaded = LoadedModel(name=model_dir.name, family=family)
    for net in net_names_for_family(family):
        param_path = model_dir / f"{net}.param"
        bin_path = model_dir / f"{net}.bin"
        graph = parse_param(param_path)
        if bin_path.exists():
            weights = load_bin(graph, bin_path)
            synthetic = False
        else:
            weights = synthesize_weights(graph, f"{model_dir.name}/{net}",
                                         synth_mode)
            synthetic = True
        loaded.nets[net] = LoadedNet(graph=graph, weights=weights, synthetic=synthetic)
    return loaded
