"""Multi-chip sharded pipeline step on the virtual 8-device CPU mesh."""

import numpy as np
import jax

from ohpipeline_jax import parallel
from ohpipeline_jax.core import events as ev
from ohpipeline_jax.core.streaminfo import PcmStreamInfo
from ohpipeline_jax.pipeline.branch import Brancher, IciBranch


class TestShardedStep:
    def test_mesh_shape(self):
        mesh = parallel.make_mesh(8)
        assert mesh.devices.size == 8 and mesh.axis_names == ("dp",)

    def test_full_step_all_stages(self):
        mesh = parallel.make_mesh(8)
        dp = mesh.devices.shape[0]
        nframes = max(8, dp * 2)
        args = parallel.example_step_args(nframes=nframes, n=1024)
        rng = np.random.default_rng(3)
        B = dp * 2
        aac_spec = rng.standard_normal((4, B, 1024)).astype(np.float32)
        aac_opidx = np.zeros((4, B), np.int32)
        aac_ov = np.zeros((B, 1024), np.float32)
        v_spec = rng.standard_normal((B, 1024)).astype(np.float32)
        step = parallel.sharded_pipeline_step(mesh, num_channels=2)
        with mesh:
            rendered, meters, aac_pcm, new_ov, vtime = step(
                *args, aac_spec, aac_opidx, aac_ov, v_spec)
            rendered.block_until_ready()
        assert rendered.shape == (nframes, 2, 1024)
        assert meters.shape == (nframes,)
        assert aac_pcm.shape == (4, B, 1024)
        assert vtime.shape == (B, 2048)
        # the meters collective replicates across every device
        assert len(set(d.device for d in meters.addressable_shards)) == 8
        # vorbis IMDCT matches the single-device reference op
        from ohpipeline_jax.codecs.vorbis.synthesis import imdct_many
        ref = imdct_many(v_spec, 2048)
        np.testing.assert_allclose(np.asarray(vtime), ref, atol=1e-3)


class TestRoomRenderGrid:
    """Per-room pipeline render chain (delay + clock-skew resample +
    ramp x gain) sharded over the mesh, vs a numpy oracle."""

    def test_matches_numpy_oracle(self):
        mesh = parallel.make_mesh(8)
        dp = mesh.devices.shape[0]
        rng = np.random.default_rng(7)
        C, N = 2, 2048
        master = rng.integers(-30000, 30000, (C, N)).astype(np.float32)
        R = dp
        gains = np.linspace(0.2, 1.0, R).astype(np.float32)
        delays = np.array(([0.0, 0.5, 3.0, 10.25] * ((R + 3) // 4))[:R],
                          np.float32)
        skew = np.linspace(-200.0, 200.0, R).astype(np.float32)
        skew[0] = 0.0                    # room 0: pure ramped mix check
        ramp0 = np.full(R, 0.0, np.float32)
        ramp1 = np.ones(R, np.float32)

        with mesh:
            out = jax.jit(lambda m, *a: parallel.room_render_grid(
                mesh, m, *a))(master, gains, delays, skew, ramp0, ramp1)
            shards = {d.device for d in out.addressable_shards}
            out = np.asarray(out)
        assert out.shape == (R, C, N)
        assert len(shards) == 8          # rooms really live on the mesh

        # numpy oracle, f32 math mirrored
        t = np.arange(N, dtype=np.float32)
        for r in range(R):
            pos = t * np.float32(1.0 + skew[r] * 1e-6) - delays[r]
            i0 = np.clip(np.floor(pos).astype(np.int32), 0, N - 1)
            i1 = np.clip(i0 + 1, 0, N - 1)
            frac = (pos - i0).astype(np.float32)
            x = master[:, i0] * (1 - frac) + master[:, i1] * frac
            x[:, (pos < 0) | (pos > N - 1)] = 0.0
            ramp = ramp0[r] + (ramp1[r] - ramp0[r]) * t / np.float32(N)
            ref = x * (gains[r] * ramp)
            # XLA fuses pos = t*(1+skew) - delay differently from numpy;
            # a floor()-boundary flip moves one interpolation tap (~1e-3
            # relative on +-30000-scale PCM)
            np.testing.assert_allclose(out[r], ref, rtol=5e-3, atol=1.0)

        # room 0 (no delay/skew, unity gain ramp) is the pure ramped mix;
        # rooms with delay start silent for ceil(delay) samples
        np.testing.assert_allclose(
            out[0], master * (gains[0] * np.arange(N, dtype=np.float32)
                              / np.float32(N)), atol=1e-2)
        assert np.all(out[2][:, :3] == 0.0)


class _Up:
    def __init__(self, events):
        self._ev = list(events)

    def pull(self):
        return self._ev.pop(0)


class TestIciBranch:
    """Multiroom distribution THROUGH the pipeline: a Brancher tee feeds
    IciBranch, whose fan-out collective must land the identical master
    mix on every device of the mesh (the OhmSender semantics of
    Av/Songcast over a mesh collective instead of UDP)."""

    def test_pipeline_multiroom_fanout(self):
        mesh = parallel.make_mesh(8)
        info = PcmStreamInfo(sample_rate=44100, bit_depth=16,
                             num_channels=2)
        rng = np.random.default_rng(11)
        pcm = rng.integers(-30000, 30000, (2, 2500)).astype(np.int32)
        events = [
            ev.DecodedStreamEvent(stream_id=1, info=info),
            # uneven event sizes exercise the tile re-blocking
            ev.AudioPcmEvent(pcm[:, :700], info),
            ev.AudioPcmEvent(pcm[:, 700:], info),
            ev.HaltEvent(),
        ]
        tee = Brancher(_Up(events), "tee")
        ici = IciBranch(mesh)
        tee.attach(ici)
        for _ in range(len(events)):
            tee.pull()

        # 2500 samples = 2 full tiles + a zero-padded halt tile
        assert ici.tiles_sent == 3
        rooms = ici.rooms()
        assert len(rooms) == 8
        tail = np.zeros((2, IciBranch.TILE), np.float32)
        tail[:, :2500 - 2048] = pcm[:, 2048:].astype(np.float32)
        for room in rooms:
            np.testing.assert_array_equal(room, tail)
        assert ici.peak == float(np.abs(tail).max())
