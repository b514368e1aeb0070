"""NeRFactor's ablation of the learned BRDF prior: an analytic GGX
microfacet BRDF, with a scalar roughness in [0, 1] as the per-point BRDF
property (counterpart of nerfactor_tpu/models/nerfactor_microfacet.py;
reference nerfactor/models/nerfactor_microfacet.py).

The roughness head is the base class's BRDF head at width 1 through a
sigmoid; the specular lobe is ``ops/microfacet.microfacet_spec`` with
Schlick's F0 = ``fresnel_f0`` (0.04 when the config has none), and the
base class's render algebra (albedo/pi + achromatic spec, contracted
against the lights) is unchanged. On CUDA tensors the albedo, roughness,
normal and visibility heads run kernel K1; no BRDF-prior chain exists, so
kernel K2 never launches. Checkpoints hold no ``brdf_mlp``, ``brdf_out``
or ``latent_code`` leaves, and ``to_vis`` has no ``seen_z``.

The shipped ``nerfactor_microfacet.ini`` sets ``rough_min`` and
``default_rough``; neither this model nor the JAX package's or the
reference's reads them (the lobe's own default roughness, 0.3, applies
only to a call without one, which the model never makes).
"""

import numpy as np

from nerfactor_tpu_torch.models import networks
from nerfactor_tpu_torch.models.nerfactor import Model as NeRFactorModel
from nerfactor_tpu_torch.ops.microfacet import microfacet_spec


class Model(NeRFactorModel):
    uses_learned_brdf = False

    def _init_brdf_config(self, config):
        """Scalar roughness; no learned prior and no Rusinkiewicz
        embedding (reference nerfactor_microfacet.py:37-41)."""
        self.pred_brdf = config.getboolean('pred_brdf')
        self.brdf_model_ckpt = None
        self.config_brdf = None
        self.z_dim = 1
        self.normalize_brdf_z = False
        self.pos_enc_rusink = False
        self.n_freqs_rusink = None
        self.fresnel_f0 = config.getfloat('fresnel_f0', fallback=0.04)

    def _make_brdf_z_out_spec(self):
        # Sigmoid, so roughness lies in [0, 1]
        return networks.MLPSpec(
            self.specs['brdf_z_mlp'].out_dim, [self.z_dim], acts='sigmoid')

    def eval_spec_at(self, params, pts2l, pts2c, normal, brdf_prop):
        """(N,L,3),(N,3),(N,3),(N,1) -> (N,L) achromatic GGX lobe; the
        base class composes albedo/pi + spec in its render."""
        del params  # the analytic BRDF has no weights
        return microfacet_spec(pts2l, pts2c, normal, rough=brdf_prop,
                               f0=self.fresnel_f0)

    def _brdf_prop_as_img(self, brdf_prop, seen_z):
        """Roughness as a gray three-channel image."""
        del seen_z
        return np.concatenate([brdf_prop] * 3, axis=-1)
