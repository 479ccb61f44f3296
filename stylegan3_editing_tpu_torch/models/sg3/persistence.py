"""Self-contained reader for reference checkpoint pickles.

A copy of the JAX package's `models/sg3/persistence.py` (numpy and torch
only). Reads the two legacy formats WITHOUT importing the reference
checkout and WITHOUT executing any code embedded in the pickle:

1. Official SG3/SG2 `.pkl`s whose networks were wrapped by
   `torch_utils.persistence.persistent_class` (reference
   torch_utils/persistence.py:36-133). Those pickles reconstruct via
   `_reconstruct_persistent_obj(meta)` where `meta` carries the original
   *module source code* plus the object state. The reference re-executes
   that source; here `find_class` reroutes the hook to a stub builder that
   only captures `meta.state` — the parameter/buffer/submodule tree — which
   is all a converter needs. No embedded source is ever executed.

2. TF1-era StyleGAN2 pickles (`dnnlib.tflib.network.Network` triples).
   Mirrors reference models/stylegan3/legacy.py:25-299: the network objects
   deserialize into stubs, and `convert_tf_generator_state` re-maps their
   TF variable names onto the torch-style `networks_stylegan2` state-dict
   naming (weight transposes, mod_bias +1, flipped up-conv kernels) that
   the downstream converters consume.

Torch tensors inside the pickles still unpickle through torch's rebuild
functions (CPU); everything else resolves against an allowlist. A tensor's
storage arrives as bytes that `torch.storage._load_from_bytes` would read
with a full unpickler; here they go through ``torch.load(...,
weights_only=True)``, so those bytes cannot run code either.
"""

from __future__ import annotations

import io
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np


class EasyDict(dict):
    """dict with attribute access (reference dnnlib.EasyDict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


class PersistentStub:
    """Captured state of a `persistent_class` object — never executed.

    Exposes the pieces converters need: `class_name`, `init_kwargs` /
    `init_args`, and a recursive `state_dict()` over torch Module state.
    """

    def __init__(self, meta: dict):
        self.meta = dict(meta)
        self.class_name = meta.get("class_name")
        state = dict(meta.get("state") or {})
        self.state = state
        self.init_args = state.get("_init_args", ())
        self.init_kwargs = EasyDict(state.get("_init_kwargs", {}) or {})

    def _own(self, kind: str) -> Dict[str, Any]:
        return dict(self.state.get(kind) or {})

    def state_dict(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        _collect_module_state(self, "", out)
        return out

    def __repr__(self):
        return f"PersistentStub({self.class_name})"


def _to_numpy(v) -> Optional[np.ndarray]:
    if v is None:
        return None
    if isinstance(v, np.ndarray):
        return v
    if hasattr(v, "detach"):  # torch tensor / Parameter
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _collect_module_state(obj, prefix: str, out: Dict[str, np.ndarray]):
    """Walk torch-Module-shaped state (_parameters/_buffers/_modules),
    handling both PersistentStub children and real torch modules."""
    if isinstance(obj, PersistentStub):
        params = obj._own("_parameters")
        buffers = obj._own("_buffers")
        modules = obj._own("_modules")
    elif hasattr(obj, "_parameters"):  # a real torch module
        params = dict(obj._parameters)
        buffers = dict(obj._buffers)
        modules = dict(obj._modules)
    else:
        return
    for name, v in params.items():
        arr = _to_numpy(v)
        if arr is not None:
            out[prefix + name] = arr
    for name, v in buffers.items():
        arr = _to_numpy(v)
        if arr is not None:
            out[prefix + name] = arr
    for name, child in modules.items():
        if child is not None:
            _collect_module_state(child, prefix + name + ".", out)


def _reconstruct_stub(meta) -> PersistentStub:
    return PersistentStub(dict(meta))


class TFNetworkStub(EasyDict):
    """Captured `dnnlib.tflib.network.Network` state (version, name,
    static_kwargs, components, variables)."""

    def __setstate__(self, state):
        # Accept both dict-state and (dict, slots) protocol forms.
        if isinstance(state, tuple):
            state = state[0] or {}
        self.update(state or {})


class TorchModuleStub:
    """Captured state of a pickled `torch.nn` module — the class itself is
    never imported or instantiated; only its pickled `__dict__`
    (`_parameters`/`_buffers`/`_modules`) is kept, which
    `_collect_module_state` already knows how to walk. Covers assets like
    the reference's `in_embeddings/tf_efficientnet_lite0.pkl` (a pickled
    `nn.Embedding` of StyleGAN-XL's ImageNet class embeddings, consumed at
    networks_stylegan3_resetting.py:137, pg_modules/discriminator.py:101)."""

    def __setstate__(self, state):
        if isinstance(state, tuple):  # (dict, slots) protocol form
            state = state[0] or {}
        self.__dict__.update(state or {})

    def state_dict(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        _collect_module_state(self, "", out)
        return out

    def __repr__(self):
        return f"TorchModuleStub({sorted(self.__dict__.keys())})"


def _safe_load_from_bytes(b: bytes):
    """Stand-in for `torch.storage._load_from_bytes` (a pickled tensor's
    storage), which reads the bytes with ``weights_only=False``: the same
    bytes through torch's weights-only unpickler, onto the CPU."""
    import torch

    return torch.load(io.BytesIO(b), map_location="cpu", weights_only=True)


def _safe_load_type(name: str):
    """Closed-map stand-in for `dill._dill._load_type` (dill-written pickles
    rebuild builtin TYPES by name, e.g. `set` for a module's
    `_non_persistent_buffers_set`). Anything outside the map is refused."""
    safe = {"set": set, "frozenset": frozenset, "dict": dict, "list": list,
            "tuple": tuple, "str": str, "bytes": bytes, "int": int,
            "float": float, "bool": bool, "complex": complex,
            "object": object, "type": type, "NoneType": type(None)}
    if name not in safe:
        raise pickle.UnpicklingError(
            f"refusing to load type {name!r} via dill._load_type")
    return safe[name]


class _StandaloneUnpickler(pickle.Unpickler):
    # Exact (module, name) pairs needed to reconstruct tensor/ndarray state.
    # Module-prefix allowlisting is NOT safe: e.g. a prefix of "builtins"
    # would resolve builtins.eval and execute attacker code from the pickle.
    _ALLOWED_EXACT = {
        ("collections", "OrderedDict"),
        ("collections", "defaultdict"),
        ("collections", "deque"),
        ("copyreg", "_reconstructor"),
        ("_codecs", "encode"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("torch._utils", "_rebuild_tensor"),
        ("torch._utils", "_rebuild_tensor_v2"),
        ("torch._utils", "_rebuild_parameter"),
        ("torch._utils", "_rebuild_device_tensor_from_numpy"),
        ("torch.serialization", "_get_layout"),
        ("torch", "Size"),
        ("torch", "device"),
        ("torch", "dtype"),
    }
    # Closed set of safe, side-effect-free builtin constructors.
    _ALLOWED_BUILTINS = {
        "list", "dict", "tuple", "set", "frozenset", "slice", "complex",
        "bytearray", "range", "int", "float", "bool", "str", "bytes",
        "object",
    }
    # torch typed-storage classes (FloatStorage, HalfStorage, ...) are data
    # containers keyed by dtype name — match the family, nothing else.
    _TORCH_STORAGE_RE = re.compile(r"^(Untyped|[A-Z]\w*)Storage$")

    def find_class(self, module, name):
        if module.startswith("torch_utils") and \
                name == "_reconstruct_persistent_obj":
            return _reconstruct_stub
        if name == "EasyDict" and module.split(".")[0] == "dnnlib":
            return EasyDict
        if module == "dnnlib.tflib.network" and name == "Network":
            return TFNetworkStub
        if module.split(".")[0] in ("dnnlib", "torch_utils"):
            # Any other reference-internal symbol: benign dict-like stub.
            return EasyDict
        if module.startswith("torch.nn."):
            # Pickled torch modules (e.g. nn.Embedding weight tables):
            # capture state WITHOUT importing/instantiating the class.
            return TorchModuleStub
        if module == "dill._dill" and name == "_load_type":
            return _safe_load_type
        if module == "torch.storage" and name == "_load_from_bytes":
            return _safe_load_from_bytes
        if (module, name) in self._ALLOWED_EXACT:
            return super().find_class(module, name)
        if module == "builtins" and name in self._ALLOWED_BUILTINS:
            return super().find_class(module, name)
        if module == "torch" and self._TORCH_STORAGE_RE.match(name):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} (not allowlisted)")


def load_network_pkl(path_or_file) -> Dict[str, Any]:
    """Read a reference network pickle standalone.

    Returns a dict with (where present) 'G', 'D', 'G_ema' as
    `PersistentStub`s — or, for TF1 pickles, torch-style state dicts
    produced by the legacy conversion — plus any auxiliary entries.
    """
    if hasattr(path_or_file, "read"):
        data = _StandaloneUnpickler(path_or_file).load()
    else:
        with open(path_or_file, "rb") as f:
            data = _StandaloneUnpickler(f).load()

    # TF1 triple (legacy.py:29-34).
    if isinstance(data, tuple) and len(data) == 3 and \
            all(isinstance(n, TFNetworkStub) for n in data):
        tf_g, tf_d, tf_gs = data
        data = dict(
            G=convert_tf_generator_state(tf_g)[0],
            D=collect_tf_params(tf_d),
            G_ema=convert_tf_generator_state(tf_gs)[0],
        )
    if not isinstance(data, dict):
        data = {"G_ema": data}
    return data


def state_dict_of(entry) -> Dict[str, np.ndarray]:
    """Flat numpy state dict for a pickle entry (stub or ready dict)."""
    if isinstance(entry, PersistentStub):
        return entry.state_dict()
    assert isinstance(entry, dict)
    return {k: _to_numpy(v) for k, v in entry.items()}


# ------------------------------------------------------------ TF1 legacy


def collect_tf_params(tf_net: TFNetworkStub) -> Dict[str, np.ndarray]:
    """Flatten a TF network stub's variables incl. components
    (legacy.py:77-87)."""
    out: Dict[str, np.ndarray] = {}

    def recurse(prefix, net):
        for name, value in net.get("variables", []):
            out[prefix + name] = np.asarray(value)
        for name, comp in dict(net.get("components", {})).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return out


def convert_tf_generator_state(
    tf_g: TFNetworkStub,
) -> Tuple[Dict[str, np.ndarray], EasyDict]:
    """TF1 StyleGAN2 generator → torch-style `networks_stylegan2` state
    dict + network kwargs (reference legacy.py:110-208).

    Name remapping: Dense layers transpose to [out, in]; conv weights
    HWIO → OIHW; up-convs additionally flip spatially; `mod_bias` gains +1;
    noise buffers map by resolution index.
    """
    if int(tf_g.get("version", 0)) < 4:
        raise ValueError("TensorFlow pickle version too low")
    tf_kwargs = EasyDict(tf_g.get("static_kwargs", {}))

    kwargs = EasyDict(
        z_dim=tf_kwargs.get("latent_size", 512),
        c_dim=tf_kwargs.get("label_size", 0),
        w_dim=tf_kwargs.get("dlatent_size", 512),
        img_resolution=tf_kwargs.get("resolution", 1024),
        img_channels=tf_kwargs.get("num_channels", 3),
        channel_base=tf_kwargs.get("fmap_base", 16384) * 2,
        channel_max=tf_kwargs.get("fmap_max", 512),
        num_fp16_res=tf_kwargs.get("num_fp16_res", 0),
        conv_clamp=tf_kwargs.get("conv_clamp", None),
        mapping_layers=tf_kwargs.get("mapping_layers", 8),
        lr_multiplier=tf_kwargs.get("mapping_lrmul", 0.01),
        w_avg_beta=tf_kwargs.get("w_avg_beta", 0.995),
    )

    tf_params = collect_tf_params(tf_g)
    res = int(kwargs.img_resolution)
    # Old progressive-growing ToRGB naming must be remapped BEFORE the
    # per-resolution extraction below consumes the synthesis keys
    # (reference legacy.py remaps first for the same reason).
    for key, value in list(tf_params.items()):
        m = re.fullmatch(r"ToRGB_lod(\d+)/(.*)", key)
        if m:
            r_lod = res // (2 ** int(m.group(1)))
            tf_params[f"synthesis/{r_lod}x{r_lod}/ToRGB/{m.group(2)}"] = value

    out: Dict[str, np.ndarray] = {}

    def put(name, value):
        out[name] = np.asarray(value)

    if "dlatent_avg" in tf_params:
        put("mapping.w_avg", tf_params["dlatent_avg"])
    for key, value in tf_params.items():
        m = re.fullmatch(r"mapping/Dense(\d+)/weight", key)
        if m:
            put(f"mapping.fc{m.group(1)}.weight", np.transpose(value))
        m = re.fullmatch(r"mapping/Dense(\d+)/bias", key)
        if m:
            put(f"mapping.fc{m.group(1)}.bias", value)
        if key == "mapping/LabelEmbed/weight":
            put("mapping.embed.weight", np.transpose(value))
        if key == "mapping/LabelEmbed/bias":
            put("mapping.embed.bias", value)

    def conv(src, dst, up=False, mod=True):
        w = tf_params.get(f"{src}/weight")
        if w is None:
            return False
        if up:
            w = w[::-1, ::-1]
        put(f"{dst}.weight", np.transpose(w, (3, 2, 0, 1)))  # HWIO→OIHW
        if f"{src}/bias" in tf_params:
            put(f"{dst}.bias", tf_params[f"{src}/bias"])
        if mod:
            put(f"{dst}.affine.weight",
                np.transpose(tf_params[f"{src}/mod_weight"]))
            put(f"{dst}.affine.bias", tf_params[f"{src}/mod_bias"] + 1)
        if f"{src}/noise_strength" in tf_params:
            put(f"{dst}.noise_strength", tf_params[f"{src}/noise_strength"])
        return True

    if "synthesis/4x4/Const/const" in tf_params:
        put("synthesis.b4.const", tf_params["synthesis/4x4/Const/const"][0])
    conv("synthesis/4x4/Conv", "synthesis.b4.conv1")
    if "synthesis/noise0" in tf_params:
        put("synthesis.b4.conv1.noise_const",
            tf_params["synthesis/noise0"][0, 0])
    conv("synthesis/4x4/ToRGB", "synthesis.b4.torgb")
    r = 8
    while r <= res:
        lg = int(np.log2(r))
        conv(f"synthesis/{r}x{r}/Conv0_up", f"synthesis.b{r}.conv0", up=True)
        conv(f"synthesis/{r}x{r}/Conv1", f"synthesis.b{r}.conv1")
        for idx, conv_name in ((2 * lg - 5, "conv0"), (2 * lg - 4, "conv1")):
            if f"synthesis/noise{idx}" in tf_params:
                put(f"synthesis.b{r}.{conv_name}.noise_const",
                    tf_params[f"synthesis/noise{idx}"][0, 0])
        conv(f"synthesis/{r}x{r}/ToRGB", f"synthesis.b{r}.torgb")
        if f"synthesis/{r}x{r}/Skip/weight" in tf_params:
            w = tf_params[f"synthesis/{r}x{r}/Skip/weight"][::-1, ::-1]
            put(f"synthesis.b{r}.skip.weight", np.transpose(w, (3, 2, 0, 1)))
        r *= 2
    return out, kwargs
