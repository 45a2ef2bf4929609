"""The TCP debug shell (ohNet Shell analogue + ohPipeline's handlers)."""

import pytest

from ohpipeline_jax.net.shell import Shell, attach_media_player, run_command


@pytest.fixture
def media_player():
    from ohpipeline_jax.av import MediaPlayer, MediaPlayerInitParams
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    pp = PipelineInitParams()
    pp.gorge_jiffies = 0
    pp.threaded_starvation_ramper = False
    mp = MediaPlayer(MediaPlayerInitParams(room="Den", name="Shelly",
                                           pipeline_params=pp))
    mp.start()
    yield mp
    mp.quit()


def test_help_quit_and_unknown():
    with Shell() as sh:
        sh.add_command("echo", lambda a: " ".join(a), "echo args back")
        assert "echo" in run_command("127.0.0.1", sh.port, "help")
        assert run_command("127.0.0.1", sh.port, "echo a b") == "a b"
        out = run_command("127.0.0.1", sh.port, "nosuch")
        assert "Unknown command" in out


def test_handler_fault_answers_not_kills():
    with Shell() as sh:
        sh.add_command("boom", lambda a: 1 // 0, "divide by zero")
        out = run_command("127.0.0.1", sh.port, "boom")
        assert out.startswith("error:")
        # session machinery still alive for the next client
        assert "boom" in run_command("127.0.0.1", sh.port, "help")


def test_media_player_command_set(media_player):
    mp = media_player
    mp.log.log("info", "hello-from-the-ring")
    with Shell() as sh:
        attach_media_player(sh, mp)
        # LoggerBuffered 'log print' (Av/Logger.cpp:113-127)
        assert "hello-from-the-ring" in \
            run_command("127.0.0.1", sh.port, "log print")
        assert "Unexpected" in run_command("127.0.0.1", sh.port, "log nope")
        # pipeline occupancy
        out = run_command("127.0.0.1", sh.port, "pipeline")
        assert "encoded_bytes=" in out and "decoded_jiffies=" in out
        # product info + sources
        info = run_command("127.0.0.1", sh.port, "info")
        assert "room=Den" in info and "name=Shelly" in info
        srcs = run_command("127.0.0.1", sh.port, "sources")
        assert srcs.count("\n") + 1 == mp.product.source_count()
        # volume get/set round-trips through the volume chain
        v0 = int(run_command("127.0.0.1", sh.port, "volume"))
        v1 = int(run_command("127.0.0.1", sh.port, f"volume {v0 + 1}"))
        assert v1 == v0 + 1
        assert mp.volumes.volume == v0 + 1


def test_media_player_opens_shell_via_init_params():
    from ohpipeline_jax.av import MediaPlayer, MediaPlayerInitParams
    from ohpipeline_jax.pipeline.manager import PipelineInitParams
    pp = PipelineInitParams()
    pp.gorge_jiffies = 0
    pp.threaded_starvation_ramper = False
    mp = MediaPlayer(MediaPlayerInitParams(pipeline_params=pp,
                                           shell_port=0))
    mp.start()
    try:
        assert mp.shell is not None
        out = run_command("127.0.0.1", mp.shell.port, "info")
        assert "room=" in out
    finally:
        mp.quit()
    assert mp.shell is None


def test_stop_before_start_is_safe():
    sh = Shell()
    sh.stop()                 # never started: must not hang, socket freed
    sh2 = Shell(port=0)
    sh2.start()
    sh2.stop()
