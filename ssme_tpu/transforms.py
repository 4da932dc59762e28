"""Constrained <-> unconstrained parameter transforms with log-Jacobians.

JAX replacement for the reference's runtime-polymorphic transform
hierarchy and ``param::pack`` container
(reference: ``include/ssme/parameters.h:27-459`` for the four scalar
bijections, ``:151-631`` for the pack).

Design: instead of per-element virtual dispatch, each parameter carries a
static integer *transform code*; all four bijections are evaluated
vectorized and combined with ``jnp.where`` masks.  This compiles to a
handful of fused elementwise VPU ops for an entire parameter vector (and
batches over chains/particles for free under ``vmap``), with no
data-dependent control flow.

The four bijections (z = transformed/unconstrained, p = constrained), with
log-Jacobians expressed as functions of the *transformed* value exactly as
in the reference (``parameters.h:334-338, 376-380, 417-419, 447-448``):

====================  =======================  =====================  ==========================
name                  trans  z = f(p)          inverse p = f^-1(z)    log|d p / d z|(z)
====================  =======================  =====================  ==========================
``null``              z = p                    p = z                  0
``log`` (0, inf)      z = log p                p = e^z                z
``logit`` (0, 1)      z = log(p/(1-p))         p = sigmoid(z)         -z - 2 log(1 + e^-z)
``twice_fisher``      z = log((1+p)/(1-p))     p = tanh(z/2)          log 2 + z - 2 log(1 + e^z)
(-1, 1)
====================  =======================  =====================  ==========================
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

# Stable integer codes for each bijection (static metadata, never traced).
TT_NULL = 0
TT_LOG = 1
TT_LOGIT = 2
TT_TWICE_FISHER = 3

_NAME_TO_CODE = {
    "null": TT_NULL,
    "log": TT_LOG,
    "logit": TT_LOGIT,
    "twice_fisher": TT_TWICE_FISHER,
}
_CODE_TO_NAME = {v: k for k, v in _NAME_TO_CODE.items()}


def codes_from_names(names: Sequence[str]) -> np.ndarray:
    """Map transform names to an int32 code vector.

    Mirrors ``param::transform::create(const std::string&)``
    (``parameters.h:289-313``) including the throw-on-unknown behavior.
    """
    try:
        return np.asarray([_NAME_TO_CODE[n] for n in names], dtype=np.int32)
    except KeyError as e:
        raise ValueError(
            f"that transform type was not accounted for: {e.args[0]!r}; "
            f"valid: {sorted(_NAME_TO_CODE)}"
        ) from None


def _masks(codes: jnp.ndarray, shape_like: jnp.ndarray):
    codes = jnp.broadcast_to(codes, shape_like.shape)
    return (
        codes == TT_LOG,
        codes == TT_LOGIT,
        codes == TT_TWICE_FISHER,
    )


def unconstrain(params: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Constrained -> unconstrained ("trans" in the reference).

    Reference semantics: ``null_trans::trans`` (``parameters.h:317-321``),
    ``log_trans::trans`` (``:431-437``), ``logit_trans::trans``
    (``:392-399``), ``twice_fisher_trans::trans`` (``:350-357``).
    Out-of-domain inputs produce nan/inf rather than throwing (pure fn).
    """
    params = jnp.asarray(params)
    is_log, is_logit, is_tf = _masks(jnp.asarray(codes), params)
    # Evaluate each bijection on a domain-safe surrogate, then select.
    p_log = jnp.where(is_log, params, 1.0)
    p_logit = jnp.where(is_logit, params, 0.5)
    p_tf = jnp.where(is_tf, params, 0.0)
    z = params
    z = jnp.where(is_log, jnp.log(p_log), z)
    z = jnp.where(is_logit, jnp.log(p_logit) - jnp.log1p(-p_logit), z)
    z = jnp.where(is_tf, jnp.log1p(p_tf) - jnp.log1p(-p_tf), z)
    return z


def constrain(trans_params: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Unconstrained -> constrained ("inv_trans" in the reference).

    Reference semantics: ``parameters.h:324-328, 360-372, 402-413,
    440-443``.  ``2/(1+e^-z) - 1`` is written as ``tanh(z/2)`` (identical,
    and overflow-free in f32/bf16).
    """
    z = jnp.asarray(trans_params)
    is_log, is_logit, is_tf = _masks(jnp.asarray(codes), z)
    p = z
    p = jnp.where(is_log, jnp.exp(jnp.where(is_log, z, 0.0)), p)
    p = jnp.where(is_logit, jax.nn.sigmoid(z), p)
    p = jnp.where(is_tf, jnp.tanh(0.5 * z), p)
    return p


def log_det_jacobian(trans_params: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Summed log|d constrained / d unconstrained| at the transformed value.

    Matches ``param::pack::get_log_jacobian`` (``parameters.h:622-631``)
    which sums per-element ``log_jacobian(trans_p)``:
    null: 0 (``:334-338``); log: z (``:447-448``);
    logit: -z - 2 log(1+e^-z) (``:417-419``);
    twice_fisher: log 2 + z - 2 log(1+e^z) (``:376-380``).
    Softplus forms are used for f32 stability.
    """
    z = jnp.asarray(trans_params)
    is_log, is_logit, is_tf = _masks(jnp.asarray(codes), z)
    lj = jnp.zeros_like(z)
    lj = jnp.where(is_log, z, lj)
    lj = jnp.where(is_logit, -z - 2.0 * jax.nn.softplus(-z), lj)
    lj = jnp.where(is_tf, jnp.log(2.0) + z - 2.0 * jax.nn.softplus(z), lj)
    return jnp.sum(lj, axis=-1)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class ParamTransform:
    """Static description of a parameter vector's per-element bijections.

    The JAX analog of the reference ``param::pack``'s transform list
    (``parameters.h:151-631``): the *values* live in plain jnp arrays (in
    the unconstrained space, as in the reference which stores transformed
    values, ``parameters.h:159``), while this object carries only static
    metadata and therefore registers as a pytree *static* node — it can be
    closed over by jitted functions and used as a dict key.
    """

    names: Tuple[str, ...]

    def __init__(self, names: Union[Sequence[str], "ParamTransform"]):
        if isinstance(names, ParamTransform):
            names = names.names
        names = tuple(names)
        codes_from_names(names)  # validate eagerly
        object.__setattr__(self, "names", names)

    @property
    def dim(self) -> int:
        return len(self.names)

    @property
    def codes(self) -> np.ndarray:
        return codes_from_names(self.names)

    def constrain(self, trans_params: jnp.ndarray) -> jnp.ndarray:
        return constrain(trans_params, self.codes)

    def unconstrain(self, params: jnp.ndarray) -> jnp.ndarray:
        return unconstrain(params, self.codes)

    def log_det_jacobian(self, trans_params: jnp.ndarray) -> jnp.ndarray:
        return log_det_jacobian(trans_params, self.codes)


class ParamPack:
    """Eager convenience container mirroring the reference ``param::pack``.

    Stores the parameter vector in the transformed (unconstrained) space
    (``parameters.h:159``) alongside its :class:`ParamTransform`.  This is
    host-side sugar for scripts and tests; jitted code should use
    :class:`ParamTransform` + raw arrays directly.
    """

    def __init__(self, params, transform: Union[ParamTransform, Sequence[str]],
                 from_transformed: bool = True):
        # matches pack(params, transform_names, from_transformed)
        # (parameters.h:463-485)
        self.transform = ParamTransform(transform)
        params = jnp.asarray(params)
        if params.shape[-1] != self.transform.dim:
            raise ValueError("params needs to be the right size (full)")
        if from_transformed:
            self._trans = params
        else:
            self._trans = self.transform.unconstrain(params)
        self._capacity = self.transform.dim

    @classmethod
    def empty(cls, numelem: int) -> "ParamPack":
        """Start an empty pack of fixed capacity for incremental
        construction — the analog of the reference's default-constructed
        ``pack<float_t, numelem>()`` (``parameters.h:503-507``) filled via
        ``add_param_and_transform``."""
        if numelem < 1:
            raise ValueError("numelem must be >= 1")
        self = cls.__new__(cls)
        self.transform = None
        self._trans = jnp.zeros((0,))
        self._capacity = int(numelem)
        return self

    def add_param_and_transform(self, elem, transform_name: str,
                                is_transformed: bool = True) -> "ParamPack":
        """Append one (value, transform) element, reference semantics
        (``parameters.h:511-537``): the value is stored in the transformed
        space, converting first when ``is_transformed=False``; adding past
        the declared capacity throws (``std::length_error``,
        ``parameters.h:521,536``).  Returns ``self`` for chaining."""
        filled = 0 if self.transform is None else self.transform.dim
        if filled >= self._capacity:
            raise ValueError("can't add any more transformations")
        names = (() if self.transform is None else self.transform.names)
        new_tf = ParamTransform(names + (transform_name,))
        elem = jnp.asarray(elem, dtype=jnp.result_type(float)).reshape(())
        if not is_transformed:
            elem = unconstrain(elem[None],
                               codes_from_names((transform_name,)))[0]
        self.transform = new_tf
        self._trans = jnp.concatenate([self._trans.reshape(-1), elem[None]])
        return self

    def _require_full(self):
        filled = 0 if self.transform is None else self.transform.dim
        if filled != self._capacity:
            raise ValueError(
                f"pack is not fully constructed: {filled} of "
                f"{self._capacity} elements added")

    @property
    def dim(self) -> int:
        return self._capacity

    def get_trans_params(self, start: int = None, end: int = None) -> jnp.ndarray:
        # subset semantics of parameters.h:598-602 (inclusive end)
        self._require_full()
        if start is None:
            return self._trans
        end = start if end is None else end
        return self._trans[..., start:end + 1]

    def get_untrans_params(self, start: int = None, end: int = None) -> jnp.ndarray:
        # parameters.h:587-618 (inclusive end)
        self._require_full()
        p = self.transform.constrain(self._trans)
        if start is None:
            return p
        end = start if end is None else end
        return p[..., start:end + 1]

    def get_log_jacobian(self) -> jnp.ndarray:
        self._require_full()
        return self.transform.log_det_jacobian(self._trans)


__all__ = [
    "TT_NULL", "TT_LOG", "TT_LOGIT", "TT_TWICE_FISHER",
    "codes_from_names", "constrain", "unconstrain", "log_det_jacobian",
    "ParamTransform", "ParamPack",
]
