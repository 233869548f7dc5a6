"""habitat_torch's ``Dataset`` and ``EpisodeIterator`` against habitat_tpu's
on the same episodes (numpy only in both).

- ``get_splits`` under each combination of its switches, and
  ``filter_episodes``, ``get_scene_episodes``, ``get_episodes``: the same
  episode ids in each split.
- ``EpisodeIterator`` with each option (no cycle, shuffle, no scene
  grouping, max_scene_repeat_episodes, max_scene_repeat_steps with its
  jitter redrawn after every forced switch, num_episode_sample): for the
  same seed the episode-id sequence over 3 cycles equals JAX's, item by
  item, with the same ``step_taken`` calls between pulls.
"""

import itertools

import pytest

from habitat_tpu.core import dataset as jds

from habitat_torch.core import dataset as tds

SCENES = ("a", "b", "c")


def _episodes(mod, n_per_scene=(4, 3, 5)):
    """Episodes of three scenes, interleaved (scene order a, b, c, a, ...)."""
    out = []
    for k in range(max(n_per_scene)):
        for s, n in zip(SCENES, n_per_scene):
            if k < n:
                out.append(mod.NavigationEpisode(episode_id=f"{s}{k}", scene_id=s, start_position=[0.0, 0.0, k]))
    return out


@pytest.mark.parametrize("collate,sort_id,uneven", list(itertools.product([True, False], repeat=3)))
def test_get_splits_match_jax(collate, sort_id, uneven):
    kw = dict(collate_scene_ids=collate, sort_by_episode_id=sort_id, allow_uneven_splits=uneven)
    for allowed in (None, ["a0", "b1", "c2", "c4", "a3"]):
        got = tds.Dataset(_episodes(tds)).get_splits(3, episodes_allowed=allowed, **kw)
        want = jds.Dataset(_episodes(jds)).get_splits(3, episodes_allowed=allowed, **kw)
        assert [[e.episode_id for e in d.episodes] for d in got] == [[e.episode_id for e in d.episodes] for d in want]


def test_dataset_queries_match_jax():
    t, j = tds.Dataset(_episodes(tds)), jds.Dataset(_episodes(jds))
    keep = lambda e: e.start_position[2] % 2 == 0  # noqa: E731
    assert [e.episode_id for e in t.filter_episodes(keep).episodes] == [
        e.episode_id for e in j.filter_episodes(keep).episodes]
    assert len(t.episodes) == 12  # filtering copies
    assert t.scene_ids == j.scene_ids == list(SCENES) == t.get_scenes_to_load()
    assert [e.episode_id for e in t.get_scene_episodes("b")] == [e.episode_id for e in j.get_scene_episodes("b")]
    assert [e.episode_id for e in t.get_episodes([5, 0, 7])] == [e.episode_id for e in j.get_episodes([5, 0, 7])]
    assert t.scene_from_scene_path("data/scenes/room_2.basis.glb") == "room_2"


# (options, steps taken per pulled episode)
ITERATOR_CASES = {
    "defaults": (dict(), 0),
    "no_cycle": (dict(cycle=False), 0),
    "shuffle": (dict(shuffle=True), 0),
    "shuffle_ungrouped": (dict(shuffle=True, group_by_scene=False), 0),
    "repeat_episodes": (dict(shuffle=True, max_scene_repeat_episodes=2), 0),
    "repeat_steps_jitter": (dict(shuffle=True, max_scene_repeat_steps=25, step_repetition_range=0.4), 7),
    "repeat_both": (dict(max_scene_repeat_episodes=3, max_scene_repeat_steps=12), 5),
    "sample": (dict(shuffle=True, num_episode_sample=7, max_scene_repeat_steps=10), 4),
}


def _sequence(mod, opts, steps, seed, n_pulls):
    it = mod.Dataset(_episodes(mod)).get_episode_iterator(seed=seed, **opts)
    out = []
    for _ in range(n_pulls):
        try:
            ep = next(it)
        except StopIteration:
            break
        out.append(ep.episode_id)
        for _ in range(steps):
            it.step_taken()
    return out


@pytest.mark.parametrize("case", list(ITERATOR_CASES))
def test_iterator_sequence_matches_jax(case):
    opts, steps = ITERATOR_CASES[case]
    pool = opts.get("num_episode_sample", 12)
    for seed in (0, 7):
        got = _sequence(tds, opts, steps, seed, 3 * pool)
        want = _sequence(jds, opts, steps, seed, 3 * pool)
        assert got == want, (seed, got, want)
        assert len(got) == (pool if opts.get("cycle", True) is False else 3 * pool)
    if case == "repeat_steps_jitter":
        # the step budget forces switches: the order differs from the same
        # iterator without it, and the jittered runs differ in length
        assert got != _sequence(tds, dict(shuffle=True), steps, 7, 3 * pool)
        assert len({len(list(g)) for _, g in itertools.groupby(x[0] for x in got)}) > 1


def test_sample_larger_than_pool_raises():
    with pytest.raises(ValueError, match="num_episode_sample"):
        tds.EpisodeIterator(_episodes(tds), num_episode_sample=13)
