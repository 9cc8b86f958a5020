"""The port's utils/text.py (a copy of the JAX package's, which the port
may not import) against the JAX package's: sentence splitting, the
token-budget split and the piece budget, on the texts of
tests/test_long_text.py, under a byte counter (the port's tokenizer), a
BPE-like rate and a word counter, with and without merging."""

import pytest

from qwen3_tts_tpu.utils import text as jtext
from qwen3_tts_tpu_torch.utils import text as ttext

TEXTS = [
    "Привет, мир! Как дела? Хорошо. Да",
    "你好。天气很好!Ну что ж… продолжим.",
    "первая строка без точки\nвторая строка",
    ("очень " * 30 + "длинное предложение, " + "с запятой, " * 10
     + "и точкой в конце."),
    "x" * 100,
    ("Сегодня прекрасная погода, и мы отправились гулять в парк. "
     "Дети играли на площадке около большого старого дуба."),
    "Да. Нет. Может быть. Конечно.",
    ("Это очень длинное предложение на кириллице без знаков, " * 4).strip(),
    "щ" * 300,
    "Раз два три. Четыре пять! Шесть семь? Восемь девять.",
    "Раз два. Три четыре! Пять шесть?",
    "...wait what. ok.",
    "!!!",
    "line one\nline two",
    "a b. c d.",
]

COUNTERS = {
    "bytes": lambda s: len(s.encode("utf-8")),
    "bpe_like": lambda s: max(1, int(len(s) * 0.4)),
    "words": lambda s: len(s.split()),
}


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_text_splitting_matches_jax(text):
    assert ttext.split_sentences(text) == jtext.split_sentences(text)
    for max_chars in (8, 32, 48):
        assert ttext.split_sentences(text, max_chars=max_chars) == \
            jtext.split_sentences(text, max_chars=max_chars)
    for count in COUNTERS.values():
        for budget in (2, 10, 33, 64):
            for merge in (True, False):
                assert ttext.split_for_budget(text, count, budget, merge) \
                    == jtext.split_for_budget(text, count, budget, merge)
    for cap in (1, 8, 200, 2000):
        for mt in (None, 1, 7, 100, 5000):
            assert ttext.piece_token_budget(cap, mt) == \
                jtext.piece_token_budget(cap, mt)
