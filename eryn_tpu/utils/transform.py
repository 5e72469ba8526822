"""Parameter-basis transformations.

JAX re-design of ``/root/reference/src/eryn/utils/transform.py:10-239``.
Functionally identical API (``transform_base_parameters``, ``fill_values``,
``both_transforms``) but implemented with functional column ops so the same
container works on NumPy arrays (host) and inside jitted likelihood wrappers
(traced ``jax.numpy``).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


__all__ = ["TransformContainer"]


def _xp_for(params):
    return jnp if isinstance(params, jnp.ndarray) else np


class TransformContainer:
    """In-basis -> likelihood-basis transforms (ref ``transform.py:10``).

    Args:
        input_basis: list of names (or ints) for the sampled basis.
        output_basis: list of names for the full likelihood basis.
        parameter_transforms: ``{key_or_tuple: fn}`` applied in the output
            basis — single-parameter transforms first, then
            multi-parameter transforms (ref ``transform.py:56-84``).
        fill_dict: ``{output_name: fixed_value}`` for non-sampled parameters.
        key_map: optional renames from input to output names.
    """

    def __init__(
        self,
        input_basis=None,
        output_basis=None,
        parameter_transforms=None,
        fill_dict=None,
        key_map={},
    ):
        self.original_parameter_transforms = parameter_transforms
        self.ndim_full = len(output_basis)
        self.ndim = len(input_basis)
        self.input_basis, self.output_basis = input_basis, output_basis

        test_inds = []
        for key in input_basis:
            if key not in output_basis and key not in key_map:
                raise ValueError(
                    "All keys in input_basis must be present in output basis, "
                    "or you must provide a key_map"
                )
            key_in = key if key not in key_map else key_map[key]
            test_inds.append(output_basis.index(key_in))
        self.test_inds = np.asarray(test_inds)

        if parameter_transforms is not None:
            self.base_transforms = {"single_param": {}, "mult_param": {}}
            for key, fn in parameter_transforms.items():
                if isinstance(key, (str, int)) and not isinstance(key, bool):
                    if key not in output_basis:
                        assert key in key_map
                        key = key_map[key]
                    self.base_transforms["single_param"][
                        output_basis.index(key)
                    ] = fn
                elif isinstance(key, tuple):
                    resolved = []
                    for sub in key:
                        if sub not in output_basis:
                            assert sub in key_map
                            sub = key_map[sub]
                        resolved.append(output_basis.index(sub))
                    self.base_transforms["mult_param"][tuple(resolved)] = fn
                else:
                    raise ValueError(
                        "Parameter transform keys must be str (or int) or "
                        f"tuple of strs (or ints). {key} is neither."
                    )
        else:
            self.base_transforms = None

        self.original_fill_dict = fill_dict
        if fill_dict is not None:
            if not isinstance(fill_dict, dict):
                raise ValueError("fill_dict must be a dictionary.")
            fill_inds = [output_basis.index(k) for k in fill_dict]
            self.fill_dict = {
                "fill_inds": np.asarray(fill_inds),
                "fill_values": np.asarray(list(fill_dict.values())),
                "test_inds": self.test_inds,
            }
        else:
            self.fill_dict = None

    # ------------------------------------------------------------------
    def transform_base_parameters(
        self, params, copy=True, return_transpose=False, xp=None
    ):
        """Apply single- then multi-parameter transforms
        (ref ``transform.py:106-152``)."""
        if self.base_transforms is None:
            return params.T if return_transpose else params

        lib = _xp_for(params)
        cols = [params[..., i] for i in range(params.shape[-1])]
        for ind, fn in self.base_transforms["single_param"].items():
            cols[ind] = fn(cols[ind])
        for inds, fn in self.base_transforms["mult_param"].items():
            out = fn(*[cols[i] for i in inds])
            for j, i in enumerate(inds):
                cols[i] = out[j]
        result = lib.stack(cols, axis=-1)
        # full axis reversal (.T), matching BOTH the reference's transform
        # path and the no-transform branch above — a partial moveaxis here
        # would give 3D+ inputs a different layout depending on whether any
        # transforms are registered
        return result.T if return_transpose else result

    def fill_values(self, params, xp=None):
        """Map sampled params into the full basis and insert fixed values
        (ref ``transform.py:155-202``)."""
        if self.fill_dict is None:
            return params
        lib = _xp_for(params)
        shape = params.shape
        out = lib.zeros(shape[:-1] + (self.ndim_full,), dtype=params.dtype)
        if lib is jnp:
            out = out.at[..., self.fill_dict["test_inds"]].set(params)
            out = out.at[..., self.fill_dict["fill_inds"]].set(
                lib.asarray(self.fill_dict["fill_values"], dtype=params.dtype)
            )
        else:
            out[..., self.fill_dict["test_inds"]] = params
            out[..., self.fill_dict["fill_inds"]] = self.fill_dict["fill_values"]
        return out

    def both_transforms(self, params, copy=True, return_transpose=False, xp=None):
        """Fill fixed values, then transform (ref ``transform.py:204-239``)."""
        temp = self.fill_values(params)
        return self.transform_base_parameters(
            temp, copy=copy, return_transpose=return_transpose
        )

    def __call__(self, params, **kwargs):
        return self.both_transforms(params, **kwargs)
