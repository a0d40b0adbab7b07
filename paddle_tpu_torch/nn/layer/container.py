"""Container layers (port of ``paddle_tpu/nn/layer/container.py``):
``Sequential``, ``LayerList``, ``LayerDict`` and ``ParameterList``, over
torch's ``_modules`` and ``_parameters``, with the reference's naming
(``"0"``, ``"1"``, ... or the given names) and indexing."""
from __future__ import annotations

from .layers import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], (list, tuple))):
            named = layers[0]                 # Sequential([(name, layer)])
        elif (layers and isinstance(layers[0], tuple) and len(layers[0]) == 2
              and isinstance(layers[0][0], str)):
            named = layers                    # Sequential((name, layer), ...)
        else:
            named = [(str(i), l) for i, l in enumerate(layers)]
        for name, layer in named:
            self.add_sublayer(str(name), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __setitem__(self, idx, layer):
        self._modules[list(self._modules)[idx]] = layer

    def __delitem__(self, idx):
        del self._modules[list(self._modules)[idx]]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or ()):
            self.add_sublayer(str(i), l)

    def _renumber(self, layers):
        self._modules.clear()
        for i, l in enumerate(layers):
            self._modules[str(i)] = l

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def extend(self, sublayers):
        for l in sublayers:
            self.append(l)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._renumber(layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx + len(self._modules) if idx < 0
                                 else idx)]

    def __setitem__(self, idx, layer):
        self._modules[str(idx + len(self._modules) if idx < 0
                          else idx)] = layer

    def __delitem__(self, idx):
        layers = list(self._modules.values())
        del layers[idx]
        self._renumber(layers)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for k, v in items:
            self.add_sublayer(k, v)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def pop(self, key):
        return self._modules.pop(key)

    def clear(self):
        self._modules.clear()

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __contains__(self, key):
        return key in self._modules

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx + len(self._parameters) if idx < 0
                                    else idx)]

    def __setitem__(self, idx, p):
        self._parameters[str(idx)] = p

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())
