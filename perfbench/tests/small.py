"""Small sizes of the cells for the CPU tests: every width narrowed,
a few rays, lights and samples; the program's plain versions in f32."""

SMALL = {
    'joint-train-graph': {
        'values': {'light_h': 2, 'n_rays_per_step': 16, 'mlp_width': 16,
                   'mlp_depth': 2, 'mlp_skip_at': 1, 'scan_steps': 2,
                   'bf16_big_chains': False},
        'config': {'brdf_prior': {'mlp_width': 16, 'mlp_depth': 2,
                                  'mlp_skip_at': 1}},
        'traffic': {'pool_rays': 256}},
    'nerf-train-graph': {
        'values': {'n_rays_per_step': 16, 'mlp_width': 16, 'enc_depth': 2,
                   'enc_skip_at': 1, 'n_samples_coarse': 8,
                   'n_samples_fine': 8, 'scan_steps': 2,
                   'bf16_big_chains': False},
        'traffic': {'pool_rays': 256}},
    'nerf-distill-march': {
        'values': {'mlp_width': 16, 'enc_depth': 2, 'enc_skip_at': 1,
                   'n_samples_coarse': 8, 'n_samples_fine': 8,
                   'mlp_chunk': 4096},
        'traffic': {'points_a_call': 40, 'light_h': 2, 'check_points': 10,
                    'bf16_march': False}},
}
