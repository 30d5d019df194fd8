"""Container layers (counterpart of ``paddle_tpu/nn/layer/container.py``)."""
from __future__ import annotations

from .layers import Layer


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and not isinstance(layers[0], Layer):
            layers = layers[0]
        if layers and isinstance(layers[0], tuple) and len(layers[0]) == 2 and isinstance(layers[0][0], str):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for idx, layer in enumerate(layers):
                self.add_sublayer(str(idx), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        keys = list(self._sub_layers.keys())
        return self._sub_layers[keys[idx]]

    def __setitem__(self, idx, layer):
        keys = list(self._sub_layers.keys())
        self._sub_layers[keys[idx]] = layer

    def __delitem__(self, idx):
        keys = list(self._sub_layers.keys())
        del self._sub_layers[keys[idx]]

    def __len__(self):
        return len(self._sub_layers)

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        if idx < 0:
            idx += len(self)
        return self._sub_layers[str(idx)]

    def __setitem__(self, idx, layer):
        if idx < 0:
            idx += len(self)
        self._sub_layers[str(idx)] = layer

    def __delitem__(self, idx):
        if isinstance(idx, slice):
            keys = list(self._sub_layers.keys())[idx]
            for k in keys:
                del self._sub_layers[k]
        else:
            del self._sub_layers[str(idx)]
        # reindex
        layers = list(self._sub_layers.values())
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._sub_layers.values())
        layers.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        l = self._sub_layers[key]
        del self._sub_layers[key]
        return l

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for k, v in sublayers:
            self.add_sublayer(k, v)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        return self._parameters[str(idx)]

    def __setitem__(self, idx, param):
        self._parameters[str(idx)] = param

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self
