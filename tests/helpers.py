"""Shared jitted entry points so tests reuse compilation caches."""

import jax

from gnn_track_finding.ops import seeding, priors, clustering, extrapolate

seed_j = jax.jit(seeding.seed_track_states, static_argnums=1)
weights_j = jax.jit(priors.compute_mixture_weights, static_argnums=1)
priors_j = jax.jit(priors.compute_prior_probabilities, static_argnums=1)
degrees_j = jax.jit(priors.update_degrees)
reweight_j = jax.jit(priors.reweight, static_argnums=1)
cluster_j = jax.jit(clustering.cluster, static_argnums=(1, 2))
message_passing_j = jax.jit(extrapolate.message_passing, static_argnums=1)


def seed_and_init(g, cfg):
    g = seed_j(g, cfg)
    g = priors.initialize_edge_activation(g)
    g = weights_j(g, False)
    g = priors_j(g, False)
    return g


def extrapolation_stage(g, cfg):
    g = message_passing_j(g, cfg)
    g = priors_j(g, True)
    g = reweight_j(g, cfg)
    g = priors_j(g, True)
    g = reweight_j(g, cfg)
    g = degrees_j(g)
    return g
