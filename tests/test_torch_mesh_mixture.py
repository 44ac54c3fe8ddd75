"""The port's mixture and composer envs and the mixture's datasets against
the JAX package's, on the CPU, as `test_torch_mesh_family.py` holds the
table setting and the chessboard (its stand-ins, sizes, draws and
tolerances; its checks, imported): 3 slots for the mixture on its default
configs (the YCB stand-ins, the die among them, and the `geom` stand-ins),
2 for the composer (3 sub-geoms a slot, the candidates `bowl` and `can`),
B=3. Two files, so that test workers run them side by side."""

import pytest

from test_torch_mesh_family import (built, check_bank, check_candidate_weights,  # noqa: F401
                                    check_default_mixture_configs, check_first_state_contacts,
                                    check_reset, check_reset_model_fields, check_step, runs)

COMPOSED = ["composer", "mixture"]


def test_default_mixture_configs_resolve():
    check_default_mixture_configs()


def test_candidate_weights_match_jax(built):
    check_candidate_weights(built)


@pytest.mark.parametrize("name", COMPOSED)
def test_bank_matches_jax(built, name):
    check_bank(built, name)


@pytest.mark.parametrize("name", COMPOSED)
def test_reset_model_fields_match_jax(built, name):
    check_reset_model_fields(built, name)


@pytest.mark.parametrize("name", COMPOSED)
def test_first_state_contacts_match_jax(built, name):
    check_first_state_contacts(built, name)


@pytest.mark.parametrize("name", COMPOSED)
def test_reset_matches_jax(built, runs, name):
    check_reset(built, runs, name)


@pytest.mark.parametrize("i", [1, 2])
@pytest.mark.parametrize("name", COMPOSED)
def test_steps_match_jax(built, runs, name, i):
    check_step(built, runs, name, i)
