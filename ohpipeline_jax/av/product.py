"""Product and source model.

Parity targets: OpenHome/Av/Product.h:91-151 (source registry, selection,
standby, room/name config, source XML for UIs), Source.h:16-115
(ISource/SourceBase — activate/deactivate, visibility config), and the
standby observer chain of PowerManager.h.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .config import ConfigManager

MAX_SOURCES = 32   # Product.h kMaxSources


class Source:
    """A selectable source (reference SourceBase, Source.h:16).

    Subclasses (playlist/radio/receiver/upnp-av/raop...) override
    activate/deactivate and drive the pipeline via their UriProvider.
    """

    #: system name tokens (reference StringIds: "Playlist", "Radio"...)
    system_name: str = "?"
    type: str = "?"

    def __init__(self, name: Optional[str] = None):
        self.name = name or self.system_name
        self.product: Optional["Product"] = None
        self.active = False

    def initialise(self, product: "Product", config: ConfigManager) -> None:
        self.product = product
        key = f"Source.{self.system_name}.Visible"
        self.visible_cfg = config.create_choice(key, {0: "No", 1: "Yes"}, 1)
        name_key = f"Source.{self.system_name}.Name"
        self.name_cfg = config.create_text(name_key, 30, self.name)
        self.name = self.name_cfg.value

        # renames / visibility flips change the source XML (the reference
        # source subscribes its config values and calls back into
        # Product, Source.cpp NameChanged/VisibleChanged)
        armed = [False]   # subscribe() fires immediately; skip that one

        def _name_changed(_key, value):
            self.name = value
            if armed[0]:
                product.source_xml_changed()

        def _visible_changed(_key, _value):
            if armed[0]:
                product.source_xml_changed()

        self.name_cfg.subscribe(_name_changed)
        self.visible_cfg.subscribe(_visible_changed)
        armed[0] = True

    @property
    def visible(self) -> bool:
        return bool(self.visible_cfg.value)

    def activate(self, auto_play: bool = False) -> None:
        self.active = True

    def deactivate(self) -> None:
        self.active = False

    def standby_enabled(self) -> None:
        """Product entered standby while this source is active."""

    def pipeline_stopped(self) -> None:
        pass


class StandbyObserver:
    def standby_enabled(self) -> None: ...
    def standby_disabled(self) -> None: ...


class Product:
    """Source registry & selection + product attributes (Product.h:91)."""

    ATTRIBUTES = "Info Time Volume Sender"   # static fallback (Product.h:123)

    def __init__(self, config: ConfigManager, room: str = "Main Room",
                 name: str = "ohpipeline-jax"):
        self._config = config
        self._sources: list[Source] = []
        self._current = -1
        self._lock = threading.RLock()
        self._observers: list[Callable[[], None]] = []
        self._standby_observers: list[StandbyObserver] = []
        self.standby = True
        self._attributes = self.ATTRIBUTES
        #: bumped whenever the source XML changes (Product::
        #: SourceXmlChangeCount; clients re-fetch SourceXml when it moves)
        self.source_xml_change_count = 1
        self.room_cfg = config.create_text("Product.Room", 30, room)
        self.name_cfg = config.create_text("Product.Name", 30, name)
        self._startup_source = config.create_text("Source.StartupName", 30,
                                                  "")

    def source_xml_changed(self) -> None:
        self.source_xml_change_count += 1
        self._notify()

    def add_attribute(self, name: str) -> None:
        """Providers register their presence (Product::AddAttribute,
        called per provider in MediaPlayer.cpp:222-253); the attribute
        string tells control points which services exist."""
        attrs = self._attributes.split()
        if name not in attrs:
            attrs.append(name)
            self._attributes = " ".join(attrs)
            self._notify()

    @property
    def attributes(self) -> str:
        return self._attributes

    # -- registration ------------------------------------------------------
    def add_source(self, source: Source) -> None:
        with self._lock:
            if len(self._sources) >= MAX_SOURCES:
                raise RuntimeError("too many sources")
            source.initialise(self, self._config)
            self._sources.append(source)
        self.source_xml_changed()

    def start(self) -> None:
        """Select the startup source (reference Product::Start)."""
        name = self._startup_source.value
        idx = 0
        for i, s in enumerate(self._sources):
            if s.system_name == name:
                idx = i
                break
        if self._sources:
            self.set_source_index(idx)

    # -- queries (UPnP Product service) ------------------------------------
    @property
    def room(self) -> str:
        return self.room_cfg.value

    @property
    def name(self) -> str:
        return self.name_cfg.value

    def source_count(self) -> int:
        return len(self._sources)

    def source(self, index: int) -> Source:
        return self._sources[index]

    def source_index(self) -> int:
        return self._current

    def current_source(self) -> Optional[Source]:
        with self._lock:
            if 0 <= self._current < len(self._sources):
                return self._sources[self._current]
            return None

    def source_xml(self) -> str:
        """Source list XML for UIs (reference Product::GetSourceXml)."""
        items = []
        for s in self._sources:
            items.append(
                f"<Source><Name>{s.name}</Name><Type>{s.type}</Type>"
                f"<Visible>{str(s.visible).lower()}</Visible>"
                f"<SystemName>{s.system_name}</SystemName></Source>")
        return "<SourceList>" + "".join(items) + "</SourceList>"

    # -- selection ---------------------------------------------------------
    def set_source_index(self, index: int, auto_play: bool = False) -> None:
        with self._lock:
            if not 0 <= index < len(self._sources):
                raise IndexError(index)
            if index == self._current and not self.standby:
                return
            if 0 <= self._current < len(self._sources):
                self._sources[self._current].deactivate()
            self._current = index
            self.standby_disable()
            self._sources[index].activate(auto_play)
        self._notify()

    def set_source_by_name(self, system_name: str,
                           auto_play: bool = False) -> None:
        for i, s in enumerate(self._sources):
            if s.system_name == system_name or s.name == system_name:
                self.set_source_index(i, auto_play)
                return
        raise KeyError(system_name)

    # -- standby (PowerManager integration) --------------------------------
    def add_standby_observer(self, obs: StandbyObserver) -> None:
        self._standby_observers.append(obs)

    def standby_enable(self) -> None:
        with self._lock:
            if self.standby:
                return
            self.standby = True
            cur = self.current_source()
            if cur:
                cur.standby_enabled()
        for o in self._standby_observers:
            o.standby_enabled()
        self._notify()

    def standby_disable(self) -> None:
        if not self.standby:
            return
        self.standby = False
        for o in self._standby_observers:
            o.standby_disabled()
        self._notify()

    # -- eventing ----------------------------------------------------------
    def add_observer(self, cb: Callable[[], None]) -> None:
        self._observers.append(cb)

    def _notify(self) -> None:
        for cb in self._observers:
            cb()
