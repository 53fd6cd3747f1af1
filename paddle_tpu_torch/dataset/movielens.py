"""MovieLens-1M (reference ``python/paddle/dataset/movielens.py``):
(user, gender, age, job, movie, category, title) -> rating.  Synthetic
fallback with latent-factor structure."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "max_user_id", "max_movie_id", "max_job_id",
           "age_table", "movie_categories"]

_N_USERS = 6040
_N_MOVIES = 3952
_N_JOBS = 21
age_table = [1, 18, 25, 35, 45, 50, 56]
_CATEGORIES = ["Action", "Adventure", "Animation", "Children's", "Comedy",
               "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
               "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
               "Thriller", "War", "Western"]


def max_user_id():
    return _N_USERS


def max_movie_id():
    return _N_MOVIES


def max_job_id():
    return _N_JOBS - 1


def movie_categories():
    return {c: i for i, c in enumerate(_CATEGORIES)}


def _synthetic(split, n):
    rng = common.synthetic_rng("movielens", split)
    u_fac = rng.normal(0, 1, size=(_N_USERS + 1, 8))
    m_fac = rng.normal(0, 1, size=(_N_MOVIES + 1, 8))
    for _ in range(n):
        u = int(rng.randint(1, _N_USERS + 1))
        m = int(rng.randint(1, _N_MOVIES + 1))
        gender = int(rng.randint(0, 2))
        age = int(rng.randint(0, len(age_table)))
        job = int(rng.randint(0, _N_JOBS))
        cats = list(rng.choice(len(_CATEGORIES),
                               size=int(rng.randint(1, 4)), replace=False))
        title = list(rng.randint(0, 5175, size=int(rng.randint(1, 6))))
        score = float(np.clip(
            3.0 + u_fac[u] @ m_fac[m] / 4.0 + rng.normal(0, 0.3), 1, 5))
        yield [u, gender, age, job, m, cats, title, score]


def train():
    def reader():
        yield from _synthetic("train", 4000)
    return reader


def test():
    def reader():
        yield from _synthetic("test", 800)
    return reader


def fetch():
    pass
