"""The port's chat templates (``omniserve_tpu_torch/conversation.py``)
against the JAX package's: every registered template, with and without a
system message, over multi-turn exchanges, gives the same string; every
model-name mapping gives the same template name."""

import dataclasses

import pytest

from omniserve_tpu import conversation as j_conv
from omniserve_tpu_torch import conversation as t_conv

NAMES = sorted(j_conv._TEMPLATES)

EXCHANGES = [
    [("Hi", None)],
    [("Hello", "Hi there."), ("What is 2 + 2?", None)],
    [("a", "b"), ("c", "d"), ("e", None)],
    [("Summarize: x y z", "x y z")],
]


def test_registries_hold_the_same_templates():
    assert sorted(t_conv._TEMPLATES) == NAMES
    for name in NAMES:
        assert (dataclasses.asdict(t_conv.get_conv_template(name))
                == dataclasses.asdict(j_conv.get_conv_template(name))), name


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("system", [None, "Be terse."])
def test_prompts_equal_jax(name, system):
    for turns in EXCHANGES:
        convs = [m.get_conv_template(name) for m in (t_conv, j_conv)]
        for c in convs:
            if system is not None:
                c.set_system_message(system)
            for user, reply in turns:
                c.append_message(c.roles[0], user)
                c.append_message(c.roles[1], reply)
        got, want = (c.get_prompt() for c in convs)
        assert got == want, (name, system, turns)
        for c in convs:
            c.update_last_message("done")
        assert convs[0].get_prompt() == convs[1].get_prompt()
    # copies are isolated
    assert t_conv.get_conv_template(name).messages == []


@pytest.mark.parametrize("path", [
    "meta-llama/Meta-Llama-3-8B-Instruct", "llama3-8b", "Llama-3.2-1B",
    "meta-llama/Llama-2-7b-chat-hf", "llama2", "mistralai/Mistral-7B",
    "mistralai/Mixtral-8x7B-v0.1", "lmsys/vicuna-7b-v1.5",
    "01-ai/Yi-34B-Chat", "01-ai/Yi-34B", "Qwen/Qwen1.5-72B-Chat",
    "some/random-model", "",
])
def test_template_names_equal_jax(path):
    assert (t_conv.get_conv_template_name(path)
            == j_conv.get_conv_template_name(path))


def test_register_conv_template():
    t = t_conv.Conversation(name="test-port-only", style="chatml")
    t_conv.register_conv_template(t)
    c = t_conv.get_conv_template("test-port-only")
    c.append_message("user", "q")
    c.append_message("assistant", None)
    assert c.get_prompt() == "<|im_start|>user\nq<|im_end|>\n" \
        "<|im_start|>assistant\n"
    del t_conv._TEMPLATES["test-port-only"]
