"""MediaPlayer — the composition root.

Parity target: OpenHome/Av/MediaPlayer.cpp:158-256 (builds TrackFactory,
ConfigManager, PowerManager, ThreadPool, Product, PipelineManager,
VolumeManager, Credentials, providers, Pins; Start at 356).  The control
plane here is the ODP-style JSON surface (ohpipeline_jax.net.odp) plus
direct Python APIs, instead of ohNet UPnP.
"""

from __future__ import annotations

from typing import Optional

from ..pipeline import PipelineInitParams, PipelineManager
from .config import ConfigManager, FileStore, RamStore
from .power import PowerManager
from .product import Product
from .sources import SourcePlaylist, SourceRadio
from .volume import VolumeManager, VolumeProfile


class MediaPlayerInitParams:
    """Reference MediaPlayerInitParams (MediaPlayer.h:127-163)."""

    def __init__(self, room: str = "Main Room", name: str = "ohpipeline-jax",
                 store_path: Optional[str] = None,
                 volume_profile: Optional[VolumeProfile] = None,
                 pipeline_params: Optional[PipelineInitParams] = None,
                 shell_port: Optional[int] = None):
        self.room = room
        self.name = name
        self.store_path = store_path
        self.volume_profile = volume_profile or VolumeProfile()
        self.pipeline_params = pipeline_params or PipelineInitParams()
        #: ohNet InitialisationParams::SetEnableShell analogue: when set
        #: (0 = ephemeral port), start() opens the TCP debug shell with
        #: the ohPipeline command set (net/shell.py)
        self.shell_port = shell_port


class MediaPlayer:
    """Owns and wires every subsystem (reference IMediaPlayer,
    MediaPlayer.h:82-124)."""

    def __init__(self, params: Optional[MediaPlayerInitParams] = None):
        p = params or MediaPlayerInitParams()
        self.store = (FileStore(p.store_path) if p.store_path
                      else RamStore())
        self.config = ConfigManager(self.store)
        self.power = PowerManager(self.store)
        self.pipeline = PipelineManager(p.pipeline_params)
        # stereo per-channel offsets + trims (the reference wires these
        # from the integration's VolumeConsumer; this build's software
        # render integration provides both by default)
        from .volume import Trims, VolumeOffsets
        profile = p.volume_profile
        offsetter = VolumeOffsets(
            self.config, ("Left", "Right"),
            offset_max_bmdb=profile.offset_max * profile.milli_db_per_step)
        trims = Trims(self.config, ("Left", "Right"))
        self.volumes = VolumeManager(self.config, profile,
                                     power=self.power,
                                     offsetter=offsetter, trims=trims)
        self.product = Product(self.config, p.room, p.name)
        # read-only manufacturer/model/product data (reference
        # IStaticDataSource -> KvpStore, queried by ProviderProduct)
        from .misc import KvpStore
        self.kvp = KvpStore({"Product.Name": p.name,
                             "Product.Info": "ohpipeline-jax renderer",
                             "Product.Url": "",
                             "Product.ImageUri": "",
                             "Product.ImageHiresUri": ""})
        from .credentials import Credentials
        self.credentials = Credentials(self.store)
        from .oauth import OAuthRegistry
        self.oauth = OAuthRegistry()
        from .reactions import ReactionRegistry
        self.reactions = ReactionRegistry()
        # pin set with the local invoker family (reference MediaPlayer
        # owns PinsManager, MediaPlayer.cpp; invokers register per
        # source/service as in TransportPins/UrlPins/RadioPins)
        from .pins import (PinsManager, PlaylistPinInvoker,
                           RadioPinInvoker, TransportPinInvoker,
                           UrlPinInvoker)
        self.pins = PinsManager(self.store)
        self.pins.add_invoker(TransportPinInvoker(self.pipeline))
        self.pins.add_invoker(UrlPinInvoker(self.pipeline))
        # shared repeat/random transport state (TransportControl.h,
        # observed by ProviderTransport and the playlist source)
        from .misc import TransportRepeatRandom
        self.transport_repeat_random = TransportRepeatRandom()
        # ring-buffered log + debug hooks (reference LoggerBuffered /
        # ProviderDebug wiring in MediaPlayer.cpp; Av/Logger.h:62-80)
        from .ops_support import BufferedLog
        self.log = BufferedLog()
        self.log_poster = None           # ILogPoster analogue
        self.ssdp_responders: list = []  # SsdpResponder-like objects
        # default sources (reference MediaPlayer adds via SourceFactory)
        self.source_playlist = SourcePlaylist(self.pipeline)
        self.source_radio = SourceRadio(self.pipeline)
        self.product.add_source(self.source_playlist)
        self.product.add_source(self.source_radio)
        self.pins.add_invoker(RadioPinInvoker(self.source_radio))
        self.pins.add_invoker(PlaylistPinInvoker(self.source_playlist,
                                                 self.product))
        # the playlist source observes the shared repeat/random state
        # (the reference's SourcePlaylist registers with
        # ITransportRepeatRandom the same way)
        self.transport_repeat_random.add_observer(
            lambda repeat, random:
            (self.source_playlist.provider.set_repeat(repeat),
             self.source_playlist.provider.set_shuffle(random)))
        # volume drives the render gain chain: wire the sink multiplier to
        # the pipeline attenuator (device-side gain application)
        self.volumes.sink.add_gain_listener(self._on_gain)
        self.shell = None                # Shell, when p.shell_port is set
        self._shell_port = p.shell_port
        self.sender = None               # SongcastSender, when enabled
        self._sender_thread = None
        self._started = False

    def add_source(self, source) -> None:
        self.product.add_source(source)

    def add_songcast_sender(self, ohm=None, songcast_mode: str = "Receiver",
                            default_channel=None):
        """Create the Songcast sender (the reference builds it inside
        SourceReceiver's ctor, SourceReceiver.cpp:236): OhmSender +
        Sender.* config values + the ProviderSender status machine,
        attached to the pipeline's songcast Brancher through a
        SenderThread.  Call before start() so the config values register
        (MediaPlayer::Start closes registration)."""
        from ..net.songcast import OhmSender
        from ..pipeline.branch import SenderThread, SongcastBranch
        from .sender import SongcastSender
        if ohm is None:
            ohm = OhmSender(multicast=False)
        self.sender = SongcastSender(self.config, ohm,
                                     name=self.product.name,
                                     songcast_mode=songcast_mode,
                                     default_channel=default_channel)
        branch = SongcastBranch(ohm)
        self._sender_thread = SenderThread(branch.push)
        self.pipeline.pipeline.brancher_songcast.attach(self._sender_thread)
        return self.sender

    def start_upnp(self, port: int = 0, host: str = "127.0.0.1",
                   ssdp: bool = True):
        """Publish the UPnP MediaRenderer control plane (SSDP + SOAP +
        GENA over net.upnp; the reference's ohNet DvDeviceStandard
        equivalent).  Returns the UpnpDevice."""
        from ..net.upnp import make_av_renderer
        self.upnp = make_av_renderer(
            self.pipeline, self.volumes,
            friendly_name=f"{self.product.room}:{self.product.name}",
            port=port, host=host)
        self.upnp.start(ssdp=ssdp)
        return self.upnp

    def start_openhome_upnp(self, odp_device=None, port: int = 0,
                            host: str = "127.0.0.1", ssdp: bool = True):
        """Publish the openhome provider family over UPnP (the same
        provider table as the ODP device, bridged to av-openhome-org
        SOAP services with GENA eventing).  Returns the UpnpDevice."""
        from ..net.upnp import make_openhome_device
        self.upnp_openhome = make_openhome_device(
            self, odp_device=odp_device, port=port, host=host)
        self.upnp_openhome.start(ssdp=ssdp)
        return self.upnp_openhome

    def _on_gain(self, multiplier: float) -> None:
        att = self.pipeline.pipeline.attenuator
        att.active = True
        att.set_attenuation(int(multiplier * (1 << 14)))

    def start(self) -> None:
        """Reference MediaPlayer::Start: close config registration, pick
        the startup source."""
        if self._started:
            return
        self.config.close()
        self.product.start()
        if self._shell_port is not None:
            from ..net.shell import Shell, attach_media_player
            self.shell = Shell(port=self._shell_port)
            attach_media_player(self.shell, self)
            self.shell.start()
        self._started = True

    def quit(self) -> None:
        if self.shell is not None:
            self.shell.stop()
            self.shell = None
        if self.sender is not None:
            self.sender.close()
        if self._sender_thread is not None:
            self._sender_thread.quit()
        self.pipeline.quit()
        if isinstance(self.store, FileStore):
            self.store.flush()
