"""Podcast pins: iTunes search/feed/new-episode logic and TuneIn OPML
episode browse with fake HTTP (reference TestPins-style)."""

import json

from ohpipeline_jax.av.config import RamStore
from ohpipeline_jax.av.pins import Pin
from ohpipeline_jax.av.podcasts import (ITunesLatestPinInvoker,
                                        ITunesListPinInvoker,
                                        ITunesPodcasts, ListenedDates,
                                        Podcast, TuneInPodcastPinInvoker,
                                        TuneInPodcasts, _parse_duration)

SEARCH = {"results": [{"collectionId": 42, "collectionName": "Show",
                       "feedUrl": "http://feed/x.rss",
                       "artworkUrl600": "http://art/a.jpg"}]}
FEED = """<rss xmlns:itunes="http://www.itunes.com/dtds/podcast-1.0.dtd">
<channel>
  <item><title>Ep 3</title><pubDate>Mon, 3 Mar 2025</pubDate>
    <itunes:duration>1:02:03</itunes:duration>
    <enclosure url="http://cdn/ep3.mp3" type="audio/mpeg"/></item>
  <item><title>Ep 2</title><pubDate>Sun, 2 Feb 2025</pubDate>
    <enclosure url="http://cdn/ep2.mp3"/></item>
  <item><title>No audio</title></item>
  <item><title>Ep 1</title><pubDate>Sat, 1 Jan 2025</pubDate>
    <enclosure url="http://cdn/ep1.mp3"/></item>
</channel></rss>"""
OPML = """<opml><body>
  <outline type="link" text="More"/>
  <outline type="audio" text="Episode A" URL="http://tunein/a.mp3"
           subtext="1 Jan" duration="120"/>
  <outline type="audio" text="Episode B" URL="http://tunein/b.mp3"
           duration="60"/>
</body></opml>"""


def fake_get(url: str) -> bytes:
    if "itunes.apple.com/search" in url or "itunes.apple.com/lookup" in url:
        return json.dumps(SEARCH).encode()
    if "feed" in url:
        return FEED.encode()
    if "opml.radiotime.com" in url:
        return OPML.encode()
    raise AssertionError(url)


class FakePlaylistSource:
    def __init__(self):
        from ohpipeline_jax.av.sources import TrackDatabase
        self.db = TrackDatabase()
        self.provider = self
        self.shuffle = None
        self.activated = []

    def set_shuffle(self, on):
        self.shuffle = on

    def activate(self, auto_play=False):
        self.activated.append(auto_play)


class TestITunes:
    def test_search_and_episodes(self):
        it = ITunesPodcasts(http_get=fake_get)
        pod = it.resolve("some show")
        assert pod.id == "42" and pod.feed_url == "http://feed/x.rss"
        eps = it.episodes(pod.feed_url)
        assert [e.title for e in eps] == ["Ep 3", "Ep 2", "Ep 1"]
        assert eps[0].duration_s == 3723
        assert eps[0].url == "http://cdn/ep3.mp3"

    def test_lookup_by_id(self):
        it = ITunesPodcasts(http_get=fake_get)
        assert it.resolve("42").name == "Show"

    def test_new_episode_check_and_dates(self):
        store = RamStore()
        dates = ListenedDates(store)
        it = ITunesPodcasts(http_get=fake_get)
        assert it.check_for_new_episode("Show", dates)
        dates.set("42", "Mon, 3 Mar 2025")
        assert not it.check_for_new_episode("Show", dates)
        # persists across instances
        dates2 = ListenedDates(store)
        assert dates2.date("42") == "Mon, 3 Mar 2025"

    def test_dates_bounded(self):
        dates = ListenedDates(RamStore())
        for i in range(40):
            dates.set(str(i), f"d{i}")
        assert dates.date("39") == "d39"
        assert dates.date("5") is None   # evicted

    def test_duration_parse(self):
        assert _parse_duration("90") == 90
        assert _parse_duration("2:05") == 125
        assert _parse_duration("") == 0
        assert _parse_duration("x") == 0


class TestInvokers:
    def test_latest_pin(self):
        played = []

        class Pm:
            def play_uri(self, uri, metadata=""):
                played.append((uri, metadata))

        dates = ListenedDates(RamStore())
        inv = ITunesLatestPinInvoker(Pm(), ITunesPodcasts(fake_get), dates)
        inv.invoke(Pin(mode="itunes", type="podcast", uri="42"))
        assert played == [("http://cdn/ep3.mp3", "Ep 3")]
        assert dates.date("42") == "Mon, 3 Mar 2025"

    def test_list_pin(self):
        src = FakePlaylistSource()
        inv = ITunesListPinInvoker(src, ITunesPodcasts(fake_get))
        inv.invoke(Pin(mode="ituneslist", type="podcast", uri="Show"))
        uris = [t.uri for t in src.db._tracks]
        assert uris == ["http://cdn/ep3.mp3", "http://cdn/ep2.mp3",
                        "http://cdn/ep1.mp3"]
        assert src.activated == [True] and src.shuffle is False

    def test_tunein_pin(self):
        src = FakePlaylistSource()
        inv = TuneInPodcastPinInvoker(src, TuneInPodcasts(fake_get))
        inv.invoke(Pin(mode="tunein", type="podcast", uri="p244756"))
        uris = [t.uri for t in src.db._tracks]
        assert uris == ["http://tunein/a.mp3", "http://tunein/b.mp3"]
