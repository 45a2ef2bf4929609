"""Track reactions (reference Av/Reactions.h + ProviderReaction.cpp):
handler registry, favourites adaptation, current-track state tracking
and the ODP Reaction service surface."""

import pytest

from ohpipeline_jax.av.reactions import (ERR_NO_CURRENT_TRACK,
                                         ERR_TRACK_NOT_REACTABLE,
                                         FavouritesReactionHandler,
                                         ReactionError, ReactionRegistry)


class _Track:
    def __init__(self, uri):
        self.uri = uri


class _Favs:
    def __init__(self):
        self.faved = set()

    def favorite_track(self, uri):
        self.faved.add(uri)
        return True

    def unfavorite_track(self, uri):
        self.faved.discard(uri)
        return True


def test_no_track_errors():
    reg = ReactionRegistry()
    with pytest.raises(ReactionError) as e:
        reg.set_reaction("love")
    assert e.value.code == ERR_NO_CURRENT_TRACK
    with pytest.raises(ReactionError) as e:
        reg.clear_reaction()
    assert e.value.code == ERR_NO_CURRENT_TRACK


def test_unreactable_track():
    reg = ReactionRegistry()
    favs = _Favs()
    reg.add_handler(FavouritesReactionHandler(
        favs, lambda u: u.startswith("tidal://")))
    reg.notify_track(_Track("file:///local.flac"))
    assert not reg.can_react
    assert reg.available_reactions == "[]"
    with pytest.raises(ReactionError) as e:
        reg.set_reaction("love")
    assert e.value.code == ERR_TRACK_NOT_REACTABLE


def test_set_and_clear_reaction():
    reg = ReactionRegistry()
    favs = _Favs()
    reg.add_handler(FavouritesReactionHandler(
        favs, lambda u: u.startswith("tidal://")))
    events = []
    reg.add_observer(lambda: events.append(
        (reg.can_react, reg.current_reaction)))
    reg.notify_track(_Track("tidal://track/9"))
    assert reg.can_react and reg.current_reaction == ""
    assert reg.available_reactions == '["love"]'
    reg.set_reaction("love")
    assert reg.current_reaction == "love"
    assert favs.faved == {"tidal://track/9"}
    reg.clear_reaction()
    assert reg.current_reaction == ""
    assert not favs.faved
    # the empty reaction clears, like ProviderReaction::SetReaction
    reg.set_reaction("love")
    reg.set_reaction("")
    assert reg.current_reaction == "" and not favs.faved
    assert events  # observers fired on state changes


def test_state_follows_track_changes():
    reg = ReactionRegistry()
    favs = _Favs()
    reg.add_handler(FavouritesReactionHandler(
        favs, lambda u: u.startswith("svc://")))
    reg.notify_track(_Track("svc://a"))
    reg.set_reaction("love")
    reg.notify_track(_Track("svc://b"))
    assert reg.current_reaction == ""       # per-track state
    reg.notify_track(_Track("svc://a"))
    assert reg.current_reaction == "love"


def test_odp_reaction_service(tmp_path):
    from ohpipeline_jax.av.media_player import (MediaPlayer,
                                                MediaPlayerInitParams)
    from ohpipeline_jax.net.providers import make_reaction_service
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    pp = PipelineInitParams()
    pp.gorge_jiffies = 0
    pp.threaded_starvation_ramper = False
    mp = MediaPlayer(MediaPlayerInitParams(pipeline_params=pp))
    try:
        svc = make_reaction_service(mp)
        favs = _Favs()
        mp.reactions.add_handler(FavouritesReactionHandler(
            favs, lambda u: u.startswith("svc://")))
        assert svc.invoke("GetCanReact", {}) == {"value": False}
        mp.reactions.notify_track(_Track("svc://t1"))
        assert svc.invoke("GetCanReact", {}) == {"value": True}
        assert svc.invoke("GetAvailableReactions", {}) \
            == {"value": '["love"]'}
        assert svc.invoke("SetReaction", {"reaction": "love"}) == {}
        assert svc.invoke("GetCurrentReaction", {}) == {"value": "love"}
        assert svc.invoke("ClearReaction", {}) == {}
        assert svc.invoke("GetCurrentReaction", {}) == {"value": ""}
    finally:
        mp.pipeline.quit()
